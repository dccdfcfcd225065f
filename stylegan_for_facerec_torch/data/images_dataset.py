"""Single-image dataset for inversion: a directory (walked recursively) or a
.txt file list; images resized to ``size`` and mapped to [-1, 1], HWC."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".webp")


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _load_image(path: str, size: Optional[int]) -> np.ndarray:
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


class InferenceDataset:
    def __init__(self, root: str, size: Optional[int] = 112):
        if root.endswith(".txt"):
            with open(root) as f:
                self.paths = f.read().splitlines()
        else:
            self.paths = list_images(root)
        self.size = size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _load_image(self.paths[idx], self.size)
