"""Pack RFW-style verification pairs into ``<out>.npz``.

    python -m stylegan_for_facerec_torch.tools.pack_rfw \\
        --pairs African_pairs.txt --image_root rfw/African --out rfw_African

The JAX package's ``tools/pack_rfw.py``: reads a pairs file (RFW's
``id a b`` positive and ``id1 a id2 b`` negative lines, or ``path1 path2
label``), loads the aligned images, and writes the two images of pair i at
2i and 2i + 1 of a (2N, size, size, 3) float32 [-1, 1] array 'images',
with 'issame' (N,) bool: the layout ``test_rfw --data_root`` reads.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def load_img(path, size):
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


def _is_int(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def parse_pairs(pairs_file, image_root=None):
    """[(relative path a, relative path b, same)]. A 3-column line whose
    middle field is an integer is an RFW positive pair ('m.0123 4 1':
    images 4 and 1 of one identity), never a (path, path, label) line;
    ``<id>/<id>_<nnnn>.jpg`` names RFW's images."""
    pairs = []
    with open(pairs_file) as f:
        lines = f.read().splitlines()
    for line in lines:
        cols = line.split()
        if len(cols) == 3 and cols[2] in ("0", "1") and not _is_int(cols[1]):
            pairs.append((cols[0], cols[1], cols[2] == "1"))
        elif len(cols) == 3:
            ident, a, b = cols
            pairs.append((os.path.join(ident, f"{ident}_{int(a):04d}.jpg"),
                          os.path.join(ident, f"{ident}_{int(b):04d}.jpg"),
                          True))
        elif len(cols) == 4:
            id1, a, id2, b = cols
            pairs.append((os.path.join(id1, f"{id1}_{int(a):04d}.jpg"),
                          os.path.join(id2, f"{id2}_{int(b):04d}.jpg"),
                          False))
    return pairs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", required=True)
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--out", required=True, help="output prefix (no ext)")
    ap.add_argument("--size", type=int, default=112)
    args = ap.parse_args(argv)
    pairs = parse_pairs(args.pairs, args.image_root)
    images = np.zeros((2 * len(pairs), args.size, args.size, 3), np.float32)
    issame = np.zeros(len(pairs), bool)
    for i, (a, b, same) in enumerate(pairs):
        images[2 * i] = load_img(os.path.join(args.image_root, a), args.size)
        images[2 * i + 1] = load_img(os.path.join(args.image_root, b),
                                     args.size)
        issame[i] = same
    np.savez_compressed(args.out + ".npz", images=images, issame=issame)
    print(f"packed {len(pairs)} pairs -> {args.out}.npz")
    return len(pairs)


if __name__ == "__main__":
    main()
