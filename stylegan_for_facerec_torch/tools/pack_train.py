"""Pack a labelled training image tree into uint8 shards.

    python -m stylegan_for_facerec_torch.tools.pack_train \\
        --root data/bupt/imgs --out data/bupt/packed [--image_size 128]
    python -m stylegan_for_facerec_torch.tools.train_stage3 --config ... \\
        --packed_dir data/bupt/packed

The JAX package's ``tools/pack_train.py``: every image of a
``<root>/<identity>/<file>.jpg`` tree is decoded once (the C++ loader
where it can take the tree) and written as memory-mapped uint8 NHWC shards
with its labels and metadata (``data/packed.py``), so training epochs read
the page cache instead of decoding.
"""

from __future__ import annotations

import argparse

from ..data.dataset import FacesDataset
from ..data.packed import pack_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="<root>/<identity>/*.jpg training tree")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--image_size", type=int, default=128,
                    help="packed side length (the recipe resizes to 128 "
                    "before its random 112 crop)")
    ap.add_argument("--shard_size", type=int, default=8192,
                    help="images per shard file")
    ap.add_argument("--num_workers", type=int, default=8)
    args = ap.parse_args(argv)
    ds = FacesDataset(args.root, image_size=args.image_size)
    if len(ds) == 0:
        raise SystemExit(f"no images under {args.root}")
    print(f"[pack] {len(ds)} images, {ds.n_identities} identities "
          f"-> {args.out}")
    meta = pack_dataset(ds, args.out, shard_size=args.shard_size,
                        num_workers=args.num_workers)
    gb = meta["n_images"] * meta["image_size"] ** 2 * 3 / 1e9
    print(f"[pack] done: {meta['n_shards']} shards, {gb:.2f} GB uint8")
    return meta


if __name__ == "__main__":
    main()
