#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 36 (loader-fed stage-3 steps against a
resident batch) on one checkout, for a comparison of two checkouts on one
card.

    python3 scripts/feed_ab.py --root <checkout> [--backbones ResNet_50]

Imports ``chip_smoke`` from ``--root`` (this checkout when omitted), writes
2048 seeded uint8 128² images as packed shards into a temporary directory
and runs that checkout's ``phase_loader_feed`` over them for the given
backbones (bf16 batch 256), so each checkout feeds its steps through its
own ``device_prefetch``. Prints one JSON line with the phase's rows and
the card's name and power limit. Run the checkouts in turns in one call
(A, B, B, A): two calls may land on two cards.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--backbones", nargs="+", default=["ResNet_50"])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script times the card")
    chip_smoke.FEED_BACKBONES = tuple(args.backbones)
    n, side = chip_smoke.LOADER_IMAGES, 128
    rng = np.random.RandomState(36)
    with tempfile.TemporaryDirectory() as root:
        packed = os.path.join(root, "packed")
        chip_smoke.write_packed(
            packed, rng.randint(0, 256, (n, side, side, 3), dtype=np.uint8),
            rng.randint(0, 8, n), [str(i) for i in range(8)])
        out = chip_smoke.phase_loader_feed(packed)
    out.pop("launches", None)
    print(json.dumps({"root": args.root, "feed": out}))
    print(chip_smoke.nvidia_smi_line())


if __name__ == "__main__":
    main()
