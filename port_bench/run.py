#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``stylegan_for_facerec_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Runs one cell of ``BENCHMARK.json`` on the
cards of this machine and prints, as its last line, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the plain reference beside its limit (also the last lines on
standard error). Exits nonzero, printing no result, without enough cards,
when JAX or the JAX package was loaded, or when anything fails. A cell on
four cards starts one process per card (``--rank``, internal) and
waits for all of them.

Caches stay inside the checkout at fixed paths: the port's kernels in
``stylegan_for_facerec_torch/ops/build/``, Triton's, PyTorch's extension
builds and CUDA's JIT cache under ``.bench_cache/``.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def launch(args, chips: int) -> int:
    """Start one process per card; print rank 0's result once every rank
    has ended well."""
    from port_bench.harness import core
    init = f"tcp://localhost:{core.free_port()}"
    base = [sys.executable, os.path.abspath(__file__), "--workload",
            args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace), "--init", init,
            "--t-start", repr(T_START)]
    codes, out = core.launch(lambda r: base + ["--rank", str(r)], chips,
                             T_START + core.RANK_TIMEOUT_S)
    if any(codes):
        print(f"ranks exited with {codes}", file=sys.stderr)
        return 1
    found = core.jax_loaded()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 1
    lines = out.decode().strip().splitlines()
    if not lines:
        print("rank 0 printed no result", file=sys.stderr)
        return 1
    core.print_result(json.loads(lines[-1]))
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench.harness import core
    cell = core.find_cell(args.workload)
    problem = core.device_ready(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return launch(args, cell.chips)
    out = core.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                        args.t_start or T_START, args.rank or 0, cell.chips,
                        args.init)
    if out is not None:
        if core.jax_loaded():
            print(f"modules of JAX or the JAX package were loaded: "
                  f"{core.jax_loaded()}", file=sys.stderr)
            return 1
        if args.rank is None:
            core.print_result(out)
        else:
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
