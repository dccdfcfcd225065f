"""Identity-labelled face images and the threaded batch loader, as
``stylegan_for_facerec_tpu/data/dataset.py``.

``FacesDataset`` reads a ``<root>/<identity>/<file>.jpg`` tree, strips an
``Ethnicity^`` prefix from identity folder names, and resizes every image
to ``image_size`` square (both sides, as ``Resize([128, 128])``) in
[-1, 1]; a corrupt file loads as None. ``DataLoader`` shuffles each epoch
from ``seed`` + the epoch counter (numpy ``RandomState``), drops the last
ragged batch, decodes on host threads, and replaces a corrupt sample by
resampling another index, so every batch keeps its shape. The random
crop and flip run in the trainer, on the card.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Iterator, List, Optional, Tuple

import numpy as np

ETHNICITIES = ("African", "Asian", "Caucasian", "Indian")
EXTENSIONS = (".jpg", ".jpeg", ".png")


def _strip_ethnicity(identity: str) -> str:
    """'Caucasian^m49.r8743' -> 'm49.r8743'."""
    if identity.startswith(ETHNICITIES) and "^" in identity:
        return identity[identity.rfind("^") + 1:]
    return identity


class FacesDataset:
    """Identity-labeled image-folder dataset."""

    def __init__(self, root: str, image_size: int = 128):
        self.root = root
        self.image_size = image_size
        self.filenames: List[str] = sorted(
            fn for ext in EXTENSIONS
            for fn in glob(os.path.join(root, "*", f"*{ext}")))
        ids = sorted({_strip_ethnicity(fn.split(os.sep)[-2])
                      for fn in self.filenames})
        self.id_list = ids
        self.id2label = {identity: i for i, identity in enumerate(ids)}
        self.n_identities = len(ids)

    def __len__(self):
        return len(self.filenames)

    def label_of(self, idx: int) -> int:
        identity = _strip_ethnicity(self.filenames[idx].split(os.sep)[-2])
        return self.id2label[identity]

    def load(self, idx: int) -> Optional[Tuple[np.ndarray, int]]:
        """Decode + resize to (S, S, 3) float32 in [-1, 1]; None on a
        corrupt file."""
        from PIL import Image
        s = self.image_size
        try:
            img = Image.open(self.filenames[idx]).convert("RGB")
            # both sides resized exactly, aspect-distorting, as
            # Resize([128, 128]) does
            arr = np.asarray(img.resize((s, s), Image.BILINEAR),
                             np.float32) / 255.0
        except (OSError, ValueError, SyntaxError):
            return None
        return (arr - 0.5) / 0.5, self.label_of(idx)


class DataLoader:
    """Threaded prefetching batch loader: shuffle per epoch, drop_last,
    corrupt samples replaced by resampling. Yields (float32 NHWC, int32)
    numpy batches."""

    def __init__(self, dataset: FacesDataset, batch_size: int,
                 shuffle: bool = True, num_workers: int = 8,
                 drop_last: bool = True, seed: int = 0,
                 prefetch: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _load_with_retry(self, idx: int, rng: np.random.RandomState):
        for _ in range(10):
            out = self.ds.load(idx)
            if out is not None:
                return out
            idx = rng.randint(0, len(self.ds))
        raise RuntimeError("10 consecutive corrupt samples")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        from concurrent.futures import ThreadPoolExecutor
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        nb = len(self)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def make_batch(b):
            idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
            items = list(pool.map(
                lambda i: self._load_with_retry(i, np.random.RandomState(
                    (self.seed + 7919 * i) % (2 ** 31))), idxs))
            imgs = np.stack([it[0] for it in items])
            labels = np.asarray([it[1] for it in items], np.int32)
            return imgs, labels

        from .packed import _pumped

        def batches():
            for b in range(nb):
                yield make_batch(b)

        try:
            yield from _pumped(batches, self.prefetch,
                               "data loader producer failed")
        finally:
            pool.shutdown(wait=False)
