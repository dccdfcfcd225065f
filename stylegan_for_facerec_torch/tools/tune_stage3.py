"""Stage-3 ArcFace train-step throughput and MFU sweep, the port of root
``tools/tune_stage3.py``.

Sweeps (batch size, remat, compute dtype) over ``Stage3Trainer`` steps on
seeded random images and labels, and reports images/s and MFU: the step's
model FLOPs (``torch.utils.flop_counter.FlopCounterMode`` over one step)
over its time and ``--peak``. A step's time is the difference between a
long and a short run of steps over the difference in their lengths, as
the JAX tool's scan-delta method, timed by CUDA events on the card (the
host clock on the CPU, which only the tests use). Prints one JSON line a
configuration and, with ``--out``, writes the markdown table. An
out-of-memory configuration gives an error row; any other failure ends
the run.

Usage (on the card unless ``--device cpu``):
  python -m stylegan_for_facerec_torch.tools.tune_stage3 \\
      --batches 128 256 --remat 0 1 --out tune.md
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import nn

from ..models import irse
from ..train.stage3 import Stage3Config, Stage3Trainer
from ..utils.device import resolve_device

H100_BF16_PEAK = 989e12     # H100 SXM dense bf16 FLOP/s, NVIDIA data sheet
KEYS = ("batch", "remat", "dtype", "step_ms", "imgs_per_sec",
        "tflops_per_step", "mfu")
TINY_UNITS = ((64, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 2))


class Tiny(irse.Backbone):
    """The JAX tool's harness check: an IR-SE ``Backbone`` at 32 px whose
    body is four bottleneck units, one a stage (module names as the JAX
    tool's ``Tiny``, so ``from_jax`` fills it)."""

    def __init__(self):
        super().__init__(input_size=32, num_layers=50, mode="ir_se")
        self.body = nn.Sequential(*[irse.BottleneckIR(i, d, s, se=True)
                                    for i, d, s in TINY_UNITS])


def build_backbone(name: str):
    """(backbone, input size): ``tiny``, or an ``irse`` factory at 112."""
    if name == "tiny":
        return Tiny(), 32
    return getattr(irse, name)(112), 112


def step_seconds(step: Callable[[], object], device: torch.device,
                 short: int = 2, long: int = 6) -> float:
    """Seconds a call of ``step``: (time of ``long`` calls - time of
    ``short``) / (long - short), after one warm-up call; CUDA events on
    a card, the host clock on the CPU."""
    def run(n: int) -> float:
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        return time.perf_counter() - t0

    step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_short, t_long = run(short), run(long)
    return max((t_long - t_short) / (long - short), 1e-9)


def measure(bs: int, remat: bool, dtype: str, num_classes: int,
            peak: float, model: str = "IR_SE_50", device: str = "cuda"
            ) -> dict:
    """One configuration's row: ms a step, images/s, TFLOP a step and MFU
    (unrounded)."""
    from torch.utils.flop_counter import FlopCounterMode
    dev = resolve_device(device)
    backbone, size = build_backbone(model)
    cfg = Stage3Config(num_classes=num_classes, batch_size=bs, remat=remat,
                       compute_dtype=dtype, freeze_backbone_epochs=0)
    trainer = Stage3Trainer(backbone, cfg, steps_per_epoch=1000,
                            device=str(dev), seed=0)
    images = torch.from_numpy(np.random.RandomState(0).randn(
        bs, size, size, 3).astype(np.float32)).to(dev)
    labels = torch.from_numpy(np.random.RandomState(1).randint(
        0, num_classes, bs)).to(dev)
    dt = step_seconds(lambda: trainer.train_step(images, labels, 0), dev)
    with FlopCounterMode(display=False) as fc:
        trainer.train_step(images, labels, 0)
    flops = fc.get_total_flops()
    row = {"batch": bs, "remat": remat, "dtype": dtype,
           "step_ms": dt * 1e3, "imgs_per_sec": bs / dt}
    if flops:
        row["tflops_per_step"] = flops / 1e12
        row["mfu"] = flops / dt / peak
    return row


def table(rows: List[dict]) -> str:
    lines = ["| " + " | ".join(KEYS) + " |", "|" + "---|" * len(KEYS)]
    lines += ["| " + " | ".join(str(r.get(k, "-")) for k in KEYS) + " |"
              for r in rows]
    return "\n".join(lines) + "\n"


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--remat", type=int, nargs="+", default=[0])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16"])
    ap.add_argument("--num_classes", type=int, default=28000)
    ap.add_argument("--peak", type=float, default=H100_BF16_PEAK,
                    help="the device's peak FLOP/s (default: the H100 "
                         "SXM's dense bf16 rate, 989e12)")
    ap.add_argument("--model", default="IR_SE_50",
                    help="an irse factory name, or 'tiny' to check the "
                         "harness itself")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    rows = []
    for dtype in args.dtypes:
        for remat in args.remat:
            for bs in args.batches:
                print(f"[tune] bs={bs} remat={bool(remat)} {dtype}",
                      flush=True)
                try:
                    row = measure(bs, bool(remat), dtype, args.num_classes,
                                  args.peak, model=args.model,
                                  device=args.device)
                except torch.cuda.OutOfMemoryError as e:
                    row = {"batch": bs, "remat": bool(remat),
                           "dtype": dtype, "error": repr(e)[-200:]}
                if "error" in row:      # the failed step's frames are gone
                    gc.collect()
                    torch.cuda.empty_cache()
                print(json.dumps(row), flush=True)
                rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            f.write(table(rows))
        print(f"table -> {args.out}")
    return rows


if __name__ == "__main__":
    main()
