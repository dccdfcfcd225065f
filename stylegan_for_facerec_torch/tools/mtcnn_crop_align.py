"""Detect, crop and align every face of a folder tree with MTCNN.

    python -m stylegan_for_facerec_torch.tools.mtcnn_crop_align \\
        --in_dir photos/ --out_dir aligned/ [--in_list files.txt] \\
        [--out_res 112] [--min_face_size 100] [--threshold 0.9 0.9 0.9] \\
        [--n_threads 8] [--device cuda|cpu]

The JAX package's ``tools/mtcnn_crop_align.py``: each image is zero-padded
to a square, its faces detected (``min_face_size`` 100, thresholds and NMS
thresholds 0.9), and each face's five landmarks warped onto the ArcFace
template (x shifted by 8 for the square crop) at ``out_res``², written as
``<out_dir>/<parent folder>/<file name>_<face number>.jpg``. The detector's
nets and the warps run on the card unless ``--device cpu``; images are
read, detected and written on ``--n_threads`` host threads.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.images_dataset import list_images
from ..models.mtcnn import MTCNN, find_nonreflective_similarity, warp_affine
from ..utils.device import resolve_device

ARC_SRC = np.array([
    [30.2946, 51.6963], [65.5318, 51.5014], [48.0252, 71.7366],
    [33.5493, 92.3655], [62.7299, 92.2041]], np.float32)


def ldms_transform(img, landmark5, out_res, device="cuda") -> np.ndarray:
    """The (H, W, 3) uint8 image warped so that its five landmarks (5, 2)
    land on ``ARC_SRC`` (x + 8, scaled to ``out_res``): (out_res, out_res,
    3) uint8, zero outside the image; the warp runs on ``device``, the
    card unless the caller asks for the CPU."""
    src = ARC_SRC.copy()
    src[:, 0] += 8.0
    src *= out_res / 112.0
    T, _ = find_nonreflective_similarity(
        np.asarray(landmark5, np.float64), src.astype(np.float64))
    M = T[:, 0:2].T.astype(np.float32)
    t = torch.tensor(np.asarray(img), device=resolve_device(device))
    return warp_affine(t, M, (out_res, out_res)).cpu().numpy()


def square_pad(img: np.ndarray) -> np.ndarray:
    """Zero-pad (H, W, C) to a square, the image centred (the odd pixel
    after it)."""
    h, w = img.shape[:2]
    if h > w:
        pad = h - w
        img = np.hstack([np.zeros_like(img)[:, :pad // 2], img,
                         np.zeros_like(img)[:, :pad // 2 + pad % 2]])
    elif w > h:
        pad = w - h
        img = np.vstack([np.zeros_like(img)[:pad // 2], img,
                         np.zeros_like(img)[:pad // 2 + pad % 2]])
    return img


def process_one(det, name, out_dir, out_res, min_face_size, thresholds):
    """Detect, align and write the faces of one image; the count."""
    from PIL import Image
    try:
        with Image.open(name) as im:
            img = np.asarray(im.convert("RGB"))
    except (OSError, ValueError, SyntaxError):
        print("Error reading", name)
        return 0
    img = square_pad(img)
    try:
        boxes, landmarks = det.detect_faces(
            Image.fromarray(img), min_face_size=min_face_size,
            thresholds=thresholds, nms_thresholds=(0.9, 0.9, 0.9))
    except ValueError:
        print("detector ValueError on", name)
        return 0
    tag = name.split(os.sep)[-2]
    for face_no, lm in enumerate(landmarks):
        pts = np.stack([lm[:5], lm[5:10]], axis=1)
        crop = ldms_transform(img, pts, out_res, det.device)
        out_name = os.path.join(
            out_dir, tag, os.path.basename(name) + f"_{face_no}.jpg")
        os.makedirs(os.path.dirname(out_name), exist_ok=True)
        Image.fromarray(crop).save(out_name)
    return len(landmarks)


def main(argv=None):
    ap = argparse.ArgumentParser(
        "Crop & align faces with MTCNN in a folder tree.")
    ap.add_argument("--in_dir", type=str)
    ap.add_argument("--in_list", type=str, default=None)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--out_res", type=int, default=112)
    ap.add_argument("--min_face_size", type=float, default=100.0)
    ap.add_argument("--threshold", type=float, nargs=3,
                    default=(0.9, 0.9, 0.9))
    ap.add_argument("--n_threads", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.in_list:
        with open(args.in_list) as f:
            names = f.read().splitlines()
    elif args.in_dir:
        names = list_images(args.in_dir)
    else:
        raise SystemExit("give --in_dir or --in_list")
    det = MTCNN(device=str(resolve_device(args.device)))
    with ThreadPoolExecutor(args.n_threads) as pool:
        total = sum(pool.map(lambda nm: process_one(
            det, nm, args.out_dir, args.out_res, args.min_face_size,
            tuple(args.threshold)), names))
    print(f"aligned {total} faces from {len(names)} images")
    return total


if __name__ == "__main__":
    main()
