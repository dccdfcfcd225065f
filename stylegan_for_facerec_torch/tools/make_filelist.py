"""A flat list of a folder tree's images, one absolute path a line, for
stage-2 training.

    python -m stylegan_for_facerec_torch.tools.make_filelist \\
        --in_dir faces/ --out_file faces.txt [--ext .jpg .png]

The JAX package's ``tools/make_filelist.py``.
"""

from __future__ import annotations

import argparse
import os

from ..data.images_dataset import list_images


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--out_file", required=True)
    ap.add_argument("--ext", nargs="+", default=[".jpg", ".jpeg", ".png"])
    args = ap.parse_args(argv)
    names = [n for n in list_images(args.in_dir)
             if os.path.splitext(n)[1].lower() in args.ext]
    with open(args.out_file, "w") as f:
        f.write("\n".join(os.path.abspath(n) for n in names) + "\n")
    print(f"wrote {len(names)} paths to {args.out_file}")
    return names


if __name__ == "__main__":
    main()
