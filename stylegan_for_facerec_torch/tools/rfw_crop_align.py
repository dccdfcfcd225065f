"""Align RFW images by the landmarks RFW ships.

    python -m stylegan_for_facerec_torch.tools.rfw_crop_align \\
        --in_dir rfw/African --lmk_file African_lmk.txt \\
        --out_dir rfw_aligned/African [--out_res 112] [--device cuda|cpu]

The JAX package's ``tools/rfw_crop_align.py``: RFW's ``*_lmk.txt`` lines
(``<relative path> [fields] x1 y1 ... x5 y5``) give each image's five
points, no detector is needed; each image is warped onto the ArcFace
template (``mtcnn_crop_align.ldms_transform``, on the card unless
``--device cpu``) and written under ``out_dir`` at its relative path.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..utils.device import resolve_device
from .mtcnn_crop_align import ldms_transform


def parse_lmk_file(path):
    """{relative path: (5, 2) float32 points} of the lines with at least
    11 fields (the points are the last 10)."""
    entries = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        cols = line.split()
        if len(cols) < 11:
            continue
        coords = np.asarray([float(v) for v in cols[-10:]], np.float32)
        entries[cols[0]] = coords.reshape(5, 2)
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser("Align RFW images by shipped landmarks.")
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--lmk_file", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--out_res", type=int, default=112)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from PIL import Image
    device = resolve_device(args.device)
    lmks = parse_lmk_file(args.lmk_file)
    n_ok = 0
    for rel, pts in lmks.items():
        src = os.path.join(args.in_dir, rel.lstrip("/"))
        if not os.path.exists(src):
            continue
        try:
            with Image.open(src) as im:
                img = np.asarray(im.convert("RGB"))
        except (OSError, ValueError, SyntaxError):
            print("Error reading", src)
            continue
        crop = ldms_transform(img, pts, args.out_res, device)
        dst = os.path.join(args.out_dir, rel.lstrip("/"))
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        Image.fromarray(crop).save(dst)
        n_ok += 1
    print(f"aligned {n_ok}/{len(lmks)} images")
    return n_ok


if __name__ == "__main__":
    main()
