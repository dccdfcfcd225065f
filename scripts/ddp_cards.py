#!/usr/bin/env python3
"""Data parallelism over the cards of one host with NCCL.

    python3 scripts/ddp_cards.py [--world 4]

Starts ``--world`` worker processes (``parallel/_mp_worker.py``), rank r
on card r, joined by the port's default backend (NCCL for CUDA tensors,
gloo for CPU tensors), and:

  * steps each trainer once at the recipes' widths on its slice of the
    global batch: stage 3 in f32 at (data world, model 1) and (data 2,
    model world / 2, the ArcFace head's 28 000 classes split), and in the
    recipe's bf16 at (data 1, model world), whose class shards round the
    cosine's operands; stage 1's R1 + path-length iteration (128², global
    batch 8) and one e4e iteration (E4e(256) at 112, global batch 4);
    rank 0 holds its step against one process stepping the whole batch
    on card 0 at ``chip_smoke.py`` phase 12's tolerances (Adam's first
    updates where phase 16 holds them), every rank must end bit-equal to
    rank 0, and each rank's B1/B1b/B2/B2b launches must be that
    process's;
  * measures, without holding it to those tolerances, the bf16 step at
    (data 2, model world / 2): a data axis > 1 in bf16 rounds each
    rank's gradient share to bf16 before the sum, where one process
    rounds the whole sum once, a known difference (``ROADMAP.md`` §C);
    it prints what ``compare`` finds there (``known_difference``), and
    the ranks must still end bit-equal with one process's launches;
  * times a bf16 recipe stage-3 step at 256 images a rank over the world
    and on one card alone (the same per-card batch): ms a step, images/s
    and the scaling efficiency (one card's ms over the world's);
  * runs spatially sharded synthesis over the world (each rank a band of
    the rows, halo exchanges over NCCL): the ADA G and the rosinality G
    (config-f) at 1024², f32, const noise, batch 1 and 4
    (``_mp_worker.SPATIAL_CARD_RUNS``); each rank's band must equal its
    rows of one card's image within ``chip_smoke.py``'s 1e-4 of scale
    with one card's B1/B2 launches; each rank's ms a call and peak GiB
    above the weights beside one card's.

Prints the card's name and power limit, then one JSON line. Exits nonzero
when a rank disagrees, a rank fails, or there are fewer cards than ranks.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stylegan_for_facerec_torch.parallel import _mp_worker as mp  # noqa: E402

TOL = (1e-3, 0.1, 1e-4, 1e-3)     # chip_smoke.py's MP_* (phases 12, 16)
SPATIAL_TOL = 1e-4                # chip_smoke.py's SPATIAL_TOL (phase 45)


def spatial_rows(ranks, spec, one) -> tuple:
    """(per-run numbers, failures) of each rank's band against one card."""
    rows, bad = {}, []
    for name, want in one.items():
        scale = float(want["image"].abs().max())
        row = {"ms_one_card": want["ms"],
               "peak_gib_one_card": want["peak_gib"],
               "launches_one_card": want["launches"], "ranks": []}
        for r, res in enumerate(ranks):
            got = res[spec][name]
            lo, hi = got["rows"]
            err = float((got["image"] - want["image"][:, :, lo:hi])
                        .abs().max())
            row["ranks"].append({"rows": [lo, hi], "rel_err": err / scale,
                                 "ms": got["ms"],
                                 "peak_gib": got["peak_gib"]})
            if not err <= SPATIAL_TOL * scale:
                bad.append(f"rank {r}: {name} err {err:.3e} > "
                           f"{SPATIAL_TOL} x {scale:.3e}")
            if got["launches"] != want["launches"]:
                bad.append(f"rank {r}: {name} launches {got['launches']}")
            if not got["gather_ok"]:
                bad.append(f"rank {r}: {name} gathered image")
        rows[name] = row
    return rows, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args(argv)
    if torch.cuda.device_count() < args.world:
        print(f"{torch.cuda.device_count()} cards for {args.world} ranks",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    w = args.world
    known = f"stage3_bf16:2x{w // 2}"
    spatial = f"spatial_cards:{w}x1"
    tasks = [f"stage3:{w}x1", f"stage3:2x{w // 2}", f"stage3_bf16:1x{w}",
             known, f"stage1:{w}x1", f"e4e:{w}x1", f"stage3_rate:{w}x1",
             spatial]
    out = {"world": w}
    failed = []
    with tempfile.TemporaryDirectory() as root:
        ranks = mp.spawn(tasks, w, root, device="cuda", size="full",
                         steps=1, tol=TOL, timeout=1200)
        with open(os.path.join(root, "rank0.log")) as f:
            out["rank0"] = f.readline().strip()
        for spec in tasks[:-2]:
            first = ranks[0][spec]
            bad = [f"rank 0: {b}" for b in first["bad"]]
            if spec == known:
                out[spec] = {"known_difference": bad}
                bad = []
            for r, res in enumerate(ranks):
                if res[spec]["launches"] != first["launches_one_process"]:
                    bad.append(f"rank {r}: launches {res[spec]['launches']}")
                if res[spec]["digest"] != first["digest"]:
                    bad.append(f"rank {r}: end state differs from rank 0's")
            out.setdefault(spec, {}).update(
                launches_one_process=first["launches_one_process"], bad=bad)
            failed += bad
        one = mp.run_task("stage3_rate", None, size="full", device="cuda:0")
        many = ranks[0][tasks[-2]]
        out["stage3_rate"] = {
            "ms_one_card": one["ms"], "ms_world": many["ms"],
            "images_per_s_one_card": one["images_per_s"],
            "images_per_s_world": many["images_per_s"],
            "scaling_efficiency": one["ms"] / many["ms"],
            "ms_each_rank": [r[tasks[-2]]["ms"] for r in ranks]}
        out[spatial], bad = spatial_rows(ranks, spatial, mp.run_task(
            "spatial_cards", None, size="full", device="cuda:0"))
        failed += bad
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    out["ok"] = not failed
    print(json.dumps(out))
    if failed:
        print("\n".join(failed[:20]), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
