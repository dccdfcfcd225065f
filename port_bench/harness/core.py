"""One run of one cell: everything found by name.

``BENCHMARK.json`` names the cell's configuration, its chips and the
metrics it reports; ``workloads/<cell>.json`` names the entry, the
traffic and the limits of the numbers compared; ``configs/<config>.json``
holds the configuration; ``entries/<entry>.py`` builds the port's objects
and inputs; ``metrics/<metric>.py`` reads one metric. A later cell,
configuration or metric is new files and new manifest entries.

A run: set-up (the entry's build, its compared first calls, the warm-up),
the measured window, with ``--trace 1`` a traced window after it, then the
program's state freed and the entry's check against the plain reference.
On four chips each rank runs this in its own process (one per card) and
rank 0 prints the result.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "stylegan_for_facerec_tpu")
PEAK_BF16_FLOPS = 989e12          # H100 SXM, dense, NVIDIA's data sheet
PEAK_TF32_FLOPS = 494.7e12        # H100 SXM, dense, NVIDIA's data sheet
PEAK_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12           # H100 SXM, outside the tensor cores
# the dense tensor-core peak of a configuration's compute_dtype (float32:
# cuDNN's convolutions run in TF32, PyTorch's default)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_TF32_FLOPS}
RANK_TIMEOUT_S = 340


def load_json(*parts) -> Any:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    spec: dict                     # workloads/<name>.json
    end_to_end: List[str]
    per_layer: List[str]


def find_cell(name: str, manifest: Optional[dict] = None) -> Cell:
    m = manifest or load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in m["workloads"]}
    if name not in wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    cfg_file = {c["name"]: c["file"] for c in m["configs"]}[w["config"]]

    def listed(metrics):
        return [x["name"] for x in metrics
                if name in x.get("workloads", [name])]
    return Cell(name, w["chips"], load_json(ROOT, cfg_file),
                load_json(HERE, "workloads", name + ".json"),
                listed(m["end_to_end"]), listed(m["per_layer"]))


@dataclasses.dataclass
class Ctx:
    """What an entry gets: the cell, the seed, this process's device, rank
    and world (and the port's mesh when world > 1), ``variant`` (None for
    the program as it is; the readings' control or a planted fault),
    ``sum_``, an in-place sum of a float32 device tensor over the ranks
    (None for one process)."""
    cell: Cell
    seed: int
    device: torch.device
    rank: int = 0
    world: int = 1
    mesh: Any = None
    variant: Optional[str] = None
    sum_: Any = None

    @property
    def traffic(self) -> dict:
        return self.cell.spec["traffic"]

    @property
    def cfg(self) -> dict:
        return self.cell.config


@dataclasses.dataclass
class Reading:
    """What the metric readers read."""
    setup_s: float
    chips: int
    items_per_call: int
    calls: int
    seconds: float
    call_ms: List[float]
    window_peak_bytes: int
    flops_per_call: float
    peak_flops: float               # a card's, in the cell's compute dtype
    kernel_bound_s_per_call: Optional[float]
    trace: Any = None


def free_port() -> int:
    """A free TCP port on localhost for the ranks' rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Callable[[int], List[str]], chips: int, deadline: float,
           capture: bool = True) -> Tuple[List[Optional[int]], bytes]:
    """Start one process per card, ``argv(rank)``, with rank 0's standard
    output captured (or passed through) and the others' dropped; wait for
    all of them until ``deadline`` (``time.time()``), then kill whatever
    is left and wait for it. Returns the exit codes (a killed rank's is
    negative) and rank 0's output."""
    import subprocess
    procs = [subprocess.Popen(argv(r), cwd=ROOT, stdout=(
        subprocess.PIPE if capture else None) if r == 0
        else subprocess.DEVNULL) for r in range(chips)]
    out = b""
    try:
        if capture:
            out, _ = procs[0].communicate(
                timeout=max(1.0, deadline - time.time()))
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        print("a rank did not end in time", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs], out or b""


def jax_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_ready(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {chips}")
    return None


@dataclasses.dataclass
class RankResult:
    setup_s: float
    calls: int
    seconds: float
    call_ms: List[float]
    setup_peak: int
    window_peak: int
    failed: int
    checks: Dict[str, float]
    trace: Any
    forbidden: List[str]


def run_rank(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, rank: int = 0, world: int = 1,
             init: Optional[str] = None, variant: Optional[str] = None,
             device: Optional[torch.device] = None) -> Optional[dict]:
    """One process's run; returns the result on rank 0. ``device`` other
    than this rank's card is for the CPU tests of the harness alone."""
    device = device or torch.device("cuda", rank)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    mesh = sum_ = agree = None
    if world > 1:
        import torch.distributed as dist
        from stylegan_for_facerec_torch.parallel.mesh import (
            initialize_distributed, make_mesh)
        initialize_distributed(init, world, rank)
        mesh = make_mesh(world, 1, device=str(device))

        def sum_(t):
            dist.all_reduce(t)

        def agree(stop: bool) -> bool:
            flag = torch.tensor([float(stop)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return bool(flag.item())
    ctx = Ctx(cell, seed, device, rank, world, mesh, variant, sum_)
    entry = load_module("entries", cell.spec["entry"]).setup(ctx)
    if agree is not None:
        agree(True)                             # the window opens together
    setup_s = time.time() - t_start
    setup_peak = peak_bytes(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    from .window import measure
    win = measure(entry.call, seconds, entry.first_call, agree)
    window_peak = peak_bytes(device)
    failed = entry.failed()
    tr = None
    if trace:
        from .trace import traced
        before = None
        if agree is not None:
            def before():                   # the ranks start each call
                torch.cuda.synchronize(device)      # together
                agree(True)
        tr = traced(entry.call, entry.trace_calls,
                    entry.first_call + win.calls, rank, before)
    entry.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = entry.check()
    mine = RankResult(setup_s, win.calls, win.seconds, win.call_ms,
                      setup_peak, window_peak, failed, checks, tr,
                      jax_loaded())
    ranks = [mine]
    if world > 1:
        import torch.distributed as dist
        ranks = [None] * world
        dist.all_gather_object(ranks, mine)
    if rank != 0:
        return None
    return result(cell, entry, ranks, torch.cuda.get_device_name(device)
                  if on_card else device.type)


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def result(cell: Cell, entry, ranks: List[RankResult], kind: str) -> dict:
    r0 = ranks[0]
    forbidden = sorted({m for r in ranks for m in r.forbidden})
    if forbidden:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{forbidden}")
    call_ms = [max(r.call_ms[i] for r in ranks) for i in range(r0.calls)]
    reading = Reading(
        setup_s=r0.setup_s, chips=len(ranks),
        items_per_call=entry.items_per_call, calls=r0.calls,
        seconds=max(r.seconds for r in ranks), call_ms=call_ms,
        window_peak_bytes=max(r.window_peak for r in ranks),
        flops_per_call=entry.flops_per_call,
        peak_flops=PEAK_FLOPS[cell.config["compute_dtype"]],
        kernel_bound_s_per_call=getattr(entry, "kernel_bound_s_per_call",
                                        None),
        trace=r0.trace)
    tracing = r0.trace is not None
    names = cell.per_layer if tracing else cell.end_to_end
    metrics = {}
    for name in names:
        mod = load_module("metrics", name)
        value = mod.read(reading)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    limits = cell.spec["limits"]
    checks = {k: max(r.checks[k] for r in ranks) for k in r0.checks}
    failed = sum(r.failed for r in ranks)
    correct = failed == 0 and all(
        checks[k] <= limits[k] for k in checks) and set(checks) == set(
        limits)
    device = {"platform": "gpu", "kind": kind,
              "count": len(ranks), "memory_peak_bytes": max(
                  max(r.setup_peak, r.window_peak) for r in ranks)}
    out = {"correct": correct, "attempted": r0.calls, "failed": failed,
           "metrics": metrics, "device": device}
    if tracing:
        device["busy_s"] = statistics.fmean(r.trace.busy_s for r in ranks)
        device["window_s"] = statistics.fmean(r.trace.window_s
                                              for r in ranks)
        out["breakdown"] = {"device_ops": r0.trace.device_ops,
                            "idle_gaps": r0.trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items()}
    return out


def print_result(out: dict) -> None:
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"check correct {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
