"""Image datasets: ``ImagesDataset`` (stage-2 (source, target) pairs) and
``InferenceDataset`` (single images for inversion). A root is a directory
(walked recursively) or a .txt file list; images are resized to the given
size and mapped to [-1, 1], HWC float32 numpy arrays."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

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


def _resolve(root: str) -> List[str]:
    if root.endswith(".txt"):
        with open(root) as f:
            return f.read().splitlines()
    return list_images(root)


class ImagesDataset:
    """(source, target) pairs, matched by index; the target root defaults
    to the source's. Both are resized to 112 unless told otherwise."""

    def __init__(self, source_root: str, target_root: Optional[str] = None,
                 source_size: Optional[int] = 112,
                 target_size: Optional[int] = 112):
        self.source_paths = _resolve(source_root)
        self.target_paths = _resolve(target_root or source_root)
        if len(self.source_paths) != len(self.target_paths):
            raise ValueError(f"{len(self.source_paths)} source images but "
                             f"{len(self.target_paths)} targets")
        self.source_size = source_size
        self.target_size = target_size

    def __len__(self):
        return len(self.source_paths)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        return (_load_image(self.source_paths[idx], self.source_size),
                _load_image(self.target_paths[idx], self.target_size))


class InferenceDataset:
    def __init__(self, root: str, size: Optional[int] = 112):
        self.paths = _resolve(root)
        self.size = size

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        return _load_image(self.paths[idx], self.size)
