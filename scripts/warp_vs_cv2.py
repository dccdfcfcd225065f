#!/usr/bin/env python3
"""The port's ``warp_affine`` against the installed ``cv2.warpAffine``.

    python3 scripts/warp_vs_cv2.py [--device cuda|cpu] [--images 48]

Warps seeded uint8 images (noise, the hardest case, and smooth fields, the
case of a photo) by seeded similarity transforms (scale 0.1-2, rotation up
to 30 degrees: a face crop from a photo of any size) with both, at the
crop sizes the alignment tools write (112² and 128²), and prints one JSON
line: the OpenCV version, the most levels any pixel is off, the share of
pixels off, the share off by each number of levels, and, on the card, the
same between the card's and the CPU's warp. cv2 is imported here only:
the port never imports it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stylegan_for_facerec_torch.models.mtcnn import warp_affine  # noqa: E402
from stylegan_for_facerec_torch.utils.device import resolve_device  # noqa


def image(rng: np.random.RandomState, kind: str) -> np.ndarray:
    h, w = rng.randint(90, 1025, 2)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3), np.uint8)
    coarse = rng.randint(0, 256, (max(2, h // 16), max(2, w // 16), 3),
                         np.uint8)
    return np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC))


def similarity(rng: np.random.RandomState, img: np.ndarray,
               out: int) -> np.ndarray:
    """A 2 x 3 float32 similarity taking a random square of ``img`` onto
    the ``out``² crop."""
    h, w = img.shape[:2]
    s = rng.uniform(0.1, 2.0)
    th = np.deg2rad(rng.uniform(-30, 30))
    r = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    centre = np.array([rng.uniform(0, w), rng.uniform(0, h)])
    t = out / 2.0 - r @ centre
    return np.hstack([r, t[:, None]]).astype(np.float32)


def levels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.int64) - b.astype(np.int64)).ravel()


def summary(diffs) -> dict:
    d = np.concatenate(diffs)
    return {"pixels": int(d.size), "max_levels": int(d.max()),
            "share_off": float((d > 0).mean()),
            "share_by_levels": {str(k): float((d == k).mean())
                                for k in range(1, int(d.max()) + 1)}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--images", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import cv2
    dev = resolve_device(args.device)
    rng = np.random.RandomState(args.seed)
    vs_cv2 = {"noise": [], "smooth": []}
    vs_cpu = []
    for i in range(args.images):
        kind = ("noise", "smooth")[i % 2]
        img = image(rng, kind)
        out = (112, 128)[(i // 2) % 2]
        M = similarity(rng, img, out)
        want = cv2.warpAffine(img, M, (out, out))
        got = warp_affine(torch.tensor(img, device=dev), M,
                          (out, out)).cpu().numpy()
        vs_cv2[kind].append(levels(got, want))
        if dev.type == "cuda":
            on_cpu = warp_affine(torch.tensor(img), M, (out, out))
            vs_cpu.append(levels(got, on_cpu.numpy()))
    result = {"cv2": cv2.__version__, "device": str(dev),
              "images": args.images,
              "vs_cv2": {k: summary(v) for k, v in vs_cv2.items()}}
    if vs_cpu:
        result["card_vs_cpu"] = summary(vs_cpu)
    print(json.dumps({"warp_vs_cv2": result}))


if __name__ == "__main__":
    main()
