#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):
  1. build kernels B1 (fused bias-act) and B2 (smooth 2x upsample) from
     stylegan_for_facerec_torch/ops/csrc with nvcc, in parallel;
  2. hold each kernel against its plain PyTorch version on the card at
     every shape the inversion path gives it, in f32 and bf16;
  3. run the main path: full-width PSp(output_size=256, input_size=112)
     ReStyle inversion, seeded random weights, batch 8, 5 iterations,
     and check that it launched B1 13 and B2 12 times per iteration;
  4. run the same weights and inputs on the CPU (plain versions) at
     batch 2 for 2 iterations and compare with the card's result;
  5. time each kernel at its largest on-path shape beside its memory
     bound and its plain version, and run_on_batch in images/s;
  6. profile one bf16 batch-128 run_on_batch: device time by kernel and
     the device's busy share.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, and the one before that the card's name and power
limit as nvidia-smi reports them. Exits nonzero without a GPU.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time

import torch

from stylegan_for_facerec_torch.eval.inference import run_on_batch
from stylegan_for_facerec_torch.models.psp import build_psp
from stylegan_for_facerec_torch.models.stylegan2_ada import channels_for
from stylegan_for_facerec_torch.ops import build
from stylegan_for_facerec_torch.ops.fused_act import bias_act, bias_act_plain
from stylegan_for_facerec_torch.ops.resample import (smooth_upsample,
                                                     smooth_upsample_plain)

OUTPUT_SIZE, INPUT_SIZE, BATCH, ITERS = 256, 112, 8, 5
CPU_BATCH, CPU_ITERS = 2, 2
# relative to the output's largest magnitude: the card's cuDNN convolutions
# (f32, TF32 off) and the CPU's sum in other orders through 50 IR-SE layers
# and 14 synthesis layers
CPU_REL_TOL = 1e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # f32 outside the tensor cores
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
B1_FLOPS_PER_ELEM = 5         # add, compare/select, mul, mul, clamp
B2_FLOPS_PER_INPUT = 30       # 3 x 6 vertical + 2 x 6 horizontal


def fail(msg: str):
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(f"[chip_smoke] {msg}", flush=True)


def on_path_shapes():
    """(B1 shapes, B2 shapes) that one inversion iteration gives the
    kernels at batch BATCH, NCHW."""
    res = [2 ** i for i in range(2, int(math.log2(OUTPUT_SIZE)) + 1)]
    ch = channels_for(res)
    b1 = [(BATCH, ch[r], r, r) for r in res]
    b2 = [(BATCH, ch[r], r // 2, r // 2) for r in res[1:]]
    b2 += [(BATCH, 3, r // 2, r // 2) for r in res[1:]]
    return b1, b2


def cuda_time_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 1: built {sorted(logs) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_compare(gen):
    """Kernel against plain version on the card; returns the largest
    absolute error of each kernel per dtype."""
    b1_shapes, b2_shapes = on_path_shapes()
    errs = {("bias_act", d): 0.0 for d in DTYPES}
    errs.update({("smooth_upsample", d): 0.0 for d in DTYPES})
    for dname, dtype in DTYPES.items():
        for shape in b1_shapes:
            x = (torch.randn(shape, generator=gen, device="cuda")
                 * 200).to(dtype)
            b = torch.randn(shape[1], generator=gen, device="cuda")
            got = bias_act(x, b, "lrelu", 1.0, 256.0).float()
            want = bias_act_plain(x, b, "lrelu", 1.0, 256.0).float()
            err = (got - want).abs()
            if dname == "f32":   # the same f32 operations in the same order
                tol = 1e-6 * want.abs() + 1e-6
            else:                # the plain version rounds the bias and each
                # step to bf16, the kernel once: 4 ulps of the operands
                tol = 2.0 ** -6 * math.sqrt(2) * (x.float().abs()
                                                  + b.abs()[:, None, None])
            if not bool((err <= tol).all()):
                fail(f"B1 {dname} {shape}: max err {err.max().item():.3e}")
            errs[("bias_act", dname)] = max(errs[("bias_act", dname)],
                                            err.max().item())
        for shape in b2_shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = smooth_upsample(x).float()
            want = smooth_upsample_plain(x).float()
            err = (got - want).abs()
            scale = x.float().abs().max().item()
            # f32: taps summed in another order; bf16: the plain version
            # rounds after each 1-D pass, the kernel once (2 ulps)
            tol = (2e-6 if dname == "f32" else 2.0 ** -7) * scale
            if err.max().item() > tol:
                fail(f"B2 {dname} {shape}: max err {err.max().item():.3e}"
                     f" > {tol:.3e}")
            errs[("smooth_upsample", dname)] = max(
                errs[("smooth_upsample", dname)], err.max().item())
    torch.cuda.synchronize()
    log(f"phase 2: kernels agree with their plain versions at "
        f"{len(b1_shapes)} B1 and {len(b2_shapes)} B2 shapes in f32 and "
        f"bf16; max abs err " + ", ".join(
            f"{k}/{d}={v:.3e}" for (k, d), v in errs.items()))
    return errs


def make_inputs(batch: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((batch, INPUT_SIZE, INPUT_SIZE, 3), generator=g) * 2 - 1
    avg = torch.rand((INPUT_SIZE, INPUT_SIZE, 3), generator=g) * 2 - 1
    return x, avg


def phase_main_path(model):
    x, avg = make_inputs(BATCH)
    bias_act.launches = 0
    smooth_upsample.launches = 0
    t0 = time.perf_counter()
    outs, lats = run_on_batch(model, x.cuda(), avg.cuda(), ITERS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"bias_act": bias_act.launches,
                "smooth_upsample": smooth_upsample.launches}
    n_styles = model.n_styles
    if tuple(outs.shape) != (ITERS, BATCH, 256, 256, 3):
        fail(f"outputs shape {tuple(outs.shape)}")
    if tuple(lats.shape) != (ITERS, BATCH, n_styles, 512):
        fail(f"latents shape {tuple(lats.shape)}")
    if not (torch.isfinite(outs).all() and torch.isfinite(lats).all()):
        fail("non-finite outputs")
    want = {"bias_act": 13 * ITERS, "smooth_upsample": 12 * ITERS}
    if launches != want:
        fail(f"launches {launches}, expected {want}")
    log(f"phase 3: PSp({OUTPUT_SIZE}) inversion, batch {BATCH}, {ITERS} "
        f"iterations in {dt:.2f} s (first call); launches {launches}")
    return outs, lats, launches


def phase_cpu_reference(model, outs, lats):
    cpu_model = copy.deepcopy(model).cpu()
    x, avg = make_inputs(BATCH)
    t0 = time.perf_counter()
    c_outs, c_lats = run_on_batch(cpu_model, x[:CPU_BATCH], avg, CPU_ITERS)
    dt = time.perf_counter() - t0
    for name, got, want in (("images", outs, c_outs),
                            ("latents", lats, c_lats)):
        got = got[:CPU_ITERS, :CPU_BATCH].float().cpu()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"phase 4: card vs CPU {name}: max abs err {err:.3e} "
            f"(scale {scale:.3e}, rel {err / scale:.3e}, tol "
            f"{CPU_REL_TOL:g})")
        if not err <= CPU_REL_TOL * scale:
            fail(f"card and CPU {name} differ by {err:.3e}")
    log(f"phase 4: CPU batch {CPU_BATCH}, {CPU_ITERS} iterations in "
        f"{dt:.1f} s")


def kernel_timings(gen):
    b1_shapes, b2_shapes = on_path_shapes()
    b1_shape = max(b1_shapes, key=math.prod)
    b2_shape = max(b2_shapes, key=math.prod)
    rows = {}
    for dname, dtype in DTYPES.items():
        elem = torch.finfo(dtype).bits // 8
        x = torch.randn(b1_shape, generator=gen, device="cuda").to(dtype)
        b = torch.randn(b1_shape[1], generator=gen, device="cuda")
        n = x.numel()
        ms = cuda_time_ms(lambda: bias_act(x, b, "lrelu", 1.0, 256.0))
        plain = cuda_time_ms(lambda: bias_act_plain(x, b, "lrelu", 1.0,
                                                    256.0))
        rows[("bias_act", dname)] = dict(
            shape=b1_shape, ms=ms, plain_ms=plain,
            bytes_ms=2 * n * elem / HBM_BYTES_PER_S * 1e3,
            ops_ms=B1_FLOPS_PER_ELEM * n / F32_FLOPS_PER_S * 1e3)
        x = torch.randn(b2_shape, generator=gen, device="cuda").to(dtype)
        n = x.numel()
        ms = cuda_time_ms(lambda: smooth_upsample(x))
        plain = cuda_time_ms(lambda: smooth_upsample_plain(x))
        rows[("smooth_upsample", dname)] = dict(
            shape=b2_shape, ms=ms, plain_ms=plain,
            bytes_ms=5 * n * elem / HBM_BYTES_PER_S * 1e3,
            ops_ms=B2_FLOPS_PER_INPUT * n / F32_FLOPS_PER_S * 1e3)
    for (k, d), r in rows.items():
        bound = max(r["bytes_ms"], r["ops_ms"])
        log(f"phase 5: {k} {d} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, bound {bound:.4f} ms "
            f"({bound / r['ms']:.1%} of the bytes bound)")
    return rows


def inversion_rate(model, batch: int, dtype) -> float:
    m = model if dtype == torch.float32 else copy.deepcopy(model).to(dtype)
    x, avg = make_inputs(batch, seed=1)
    x, avg = x.cuda().to(dtype), avg.cuda().to(dtype)
    outs, _ = run_on_batch(m, x, avg, ITERS)        # warm-up
    if not torch.isfinite(outs).all():
        fail(f"non-finite outputs at batch {batch} {dtype}")
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        run_on_batch(m, x, avg, ITERS)
    torch.cuda.synchronize()
    return batch * reps / (time.perf_counter() - t0)


def profile_breakdown(model, batch: int, dtype, top: int = 12):
    """Device time by kernel over one run_on_batch call (torch.profiler),
    and the device's busy share of that call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    m = copy.deepcopy(model).to(dtype)
    x, avg = make_inputs(batch, seed=2)
    x, avg = x.cuda().to(dtype), avg.cuda().to(dtype)
    run_on_batch(m, x, avg, ITERS)                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_on_batch(m, x, avg, ITERS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if dev_ms <= 0:
        log("phase 6: the profiler recorded no device time")
        return
    log(f"phase 6: profile of run_on_batch {dtype} batch {batch}: device "
        f"busy {dev_ms:.1f} ms of {wall_ms:.1f} ms wall "
        f"({dev_ms / wall_ms:.1%})")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
        t = e.self_device_time_total / 1e3
        log(f"  {t:9.2f} ms {t / dev_ms:6.1%} x{e.count:<5d} {e.key[:90]}")


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    # full-f32 convolutions and matmuls: TF32 keeps ~3 decimal digits and
    # would swamp the differences the comparisons are there to bound
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)

    phase_build()
    errs = phase_compare(gen)
    model = build_psp(OUTPUT_SIZE, INPUT_SIZE, seed=0, device="cuda")
    outs, lats, launches = phase_main_path(model)
    phase_cpu_reference(model, outs, lats)
    timings = kernel_timings(gen)
    rates = {}
    # "tf32": f32 tensors with cuDNN's TF32 convolutions, PyTorch's default
    for dname, dtype, tf32 in (("f32", torch.float32, False),
                               ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        for batch in (BATCH, 128):
            rates[(dname, batch)] = inversion_rate(model, batch, dtype)
            log(f"phase 5: run_on_batch {dname} batch {batch}, {ITERS} "
                f"iterations: {rates[(dname, batch)]:.1f} images/s")
        torch.backends.cudnn.allow_tf32 = False
    profile_breakdown(model, 128, torch.bfloat16)
    smi = nvidia_smi_line()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")

    sources = {"bias_act": ("stylegan_for_facerec_torch/ops/csrc/bias_act.cu",
                            "stylegan_for_facerec_tpu/ops/fused_act.py:72"),
               "smooth_upsample": (
                   "stylegan_for_facerec_torch/ops/csrc/smooth_upsample.cu",
                   "stylegan_for_facerec_tpu/ops/upfirdn_pallas.py:42")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r, rb = timings[(name, "f32")], timings[(name, "bf16")]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[(name, "f32")], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"]
            else "operations",
            "library_ms": None, "shape": list(r["shape"]), "dtype": "f32",
            "bf16": {"max_abs_err": errs[(name, "bf16")], "ms": rb["ms"],
                     "plain_ms": rb["plain_ms"],
                     "bound_ms": max(rb["bytes_ms"], rb["ops_ms"])}})
    print(json.dumps({"inversion_images_per_s": {
        f"{d}_batch{b}": v for (d, b), v in rates.items()}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
