#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the numbers a cell compares,
for the program as it is, for its control and for planted faults, over
many seeds in one process per card (set-up is most of a run's cost).

    python3 port_bench/readings.py --workload <cell> --seeds 1 2 3 \\
        [--variants program control half_batch ...] [--out file.jsonl]

Each (seed, variant) builds the cell's entry as a run does, makes the
entry's calls over its whole pool (a short window at the cell's load, so
that every answer the check compares is produced), frees the program and
runs the check; one JSON line per reading goes to standard output (and
``--out``). Variants: ``program``; ``control`` (the reference in the next
precision below the configuration's, or the program's own path in it:
bf16 for the float32 inversion); the faults ``unchanged_state``,
``half_batch``, ``no_exchange`` (several cards), ``altered_answer``
(inversion). Needs the cards the cell needs; it is not part of a
benchmark run.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def readings(cell, seeds, variants, rank=0, world=1, init=None,
             device=None):
    """Yield one dict a (seed, variant)."""
    import torch
    from port_bench.harness import core
    device = device or torch.device("cuda", rank)
    mesh = sum_ = None
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1:
        import torch.distributed as dist
        from stylegan_for_facerec_torch.parallel.mesh import (
            initialize_distributed, make_mesh)
        initialize_distributed(init, world, rank)
        mesh = make_mesh(world, 1, device=str(device))

        def sum_(t):
            dist.all_reduce(t)
    for seed in seeds:
        for variant in variants:
            t0 = time.time()
            ctx = core.Ctx(cell, seed, device, rank, world, mesh,
                           None if variant == "program" else variant, sum_)
            entry = core.load_module("entries", cell.spec["entry"]).setup(
                ctx)
            pool = cell.spec["traffic"]["pool"]
            for i in range(entry.first_call, entry.first_call + pool):
                entry.call(i)
            failed = entry.failed()
            entry.release()
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            checks = entry.check()
            details = getattr(entry, "details", None)
            if world > 1:
                import torch.distributed as dist
                t = torch.tensor([checks[k] for k in sorted(checks)],
                                 dtype=torch.float64)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                checks = dict(zip(sorted(checks), t.tolist()))
            del entry
            gc.collect()
            yield {"workload": cell.name, "seed": seed, "variant": variant,
                   "failed": failed, "checks": checks,
                   "details": details,
                   "seconds": time.time() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["program"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=3000.0,
                    help="seconds before the ranks of a several-card cell "
                         "are ended")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    from port_bench.harness import core
    cell = core.find_cell(args.workload)
    problem = core.device_ready(cell.chips)
    if problem:
        print(problem, file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        cmd = [sys.executable, os.path.abspath(__file__), "--workload",
               args.workload, "--seeds", *map(str, args.seeds),
               "--variants", *args.variants, "--init",
               f"tcp://localhost:{core.free_port()}"]
        if args.out:
            cmd += ["--out", args.out]
        codes, _ = core.launch(lambda r: cmd + ["--rank", str(r)],
                               cell.chips, T_START + args.timeout,
                               capture=False)
        if any(codes):
            print(f"ranks exited with {codes}", file=sys.stderr)
            return 1
        return 0
    out = open(args.out, "a") if args.out and not args.rank else None
    try:
        for r in readings(cell, args.seeds, args.variants, args.rank or 0,
                          cell.chips, args.init):
            if not args.rank:
                line = json.dumps(r)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
