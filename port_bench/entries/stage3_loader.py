"""Entry ``stage3_loader``: ``stage3_train``'s trainer fed as
``train_stage3 --packed_dir`` feeds it, through the port's
``data/packed.py``: uint8 shards read by ``PackedLoader`` (shuffled,
``loader_prefetch`` batches gathered ahead on its producer thread) and
shipped to the card by ``device_prefetch`` (``prefetch_depth`` batches
ahead, pinned and copied on a side stream), epoch after epoch. One card.

Set-up draws the traffic's ``pool`` batches as ``stage3_train`` does (the
packed set: ``pool x batch_per_chip`` uint8 faces with labels uniform over
the classes), writes them with ``write_packed`` into one shard in a new
directory under ``TMPDIR`` and opens the loader there. Every step of the
program, the compared ones too, takes the loader's next batch. The
plain reference steps the loader's first ``compared_steps`` batches,
which this entry rebuilds from ``RandomState(seed)``'s shuffle of the
set, the loader's order of the first epoch. ``release`` stops the
loader and removes the shard.
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from port_bench.entries.stage3_train import Stage3Train
from port_bench.harness import weights


def loader_seed(ctx) -> int:
    """The loader's seed: ``RandomState`` takes 32 bits, and the seed of
    epoch e is this plus e."""
    return weights.derive(ctx.seed, "loader") % 2 ** 31


def first_order(seed: int, n: int) -> np.ndarray:
    """The first epoch's order of ``PackedLoader(shuffle=True, seed)``."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    return order


class Stage3Loader(Stage3Train):
    def _first_steps(self, p0, n: int) -> dict:
        # the pool is drawn and no step has run yet: pack the pool, open
        # the loader, and keep the batches it gives first for the check
        self._open_loader()
        return super()._first_steps(p0, n)

    def _open_loader(self) -> None:
        from stylegan_for_facerec_torch.data.packed import (
            PackedLoader, PackedTrainDataset, device_prefetch, write_packed)
        ctx, t = self.ctx, self.ctx.traffic
        if ctx.world != 1:
            raise ValueError("the loader cell runs on one card")
        size = self.images.shape[-2]
        images = self.images.reshape(-1, size, size, 3)
        labels = self.labels.reshape(-1)
        self.dir = tempfile.mkdtemp(prefix="port_bench_packed_")
        write_packed(self.dir, images.cpu().numpy(),
                     labels.cpu().numpy().astype(np.int32),
                     range(ctx.cfg["num_classes"]), shard_size=len(images))
        seed = loader_seed(ctx)
        b, n = t["batch_per_chip"], t["compared_steps"]
        idx = torch.from_numpy(first_order(seed, len(images))[:n * b]).to(
            images.device)
        self.images = images[idx].reshape(n, b, size, size, 3)
        self.labels = labels[idx].reshape(n, b)
        loader = PackedLoader(PackedTrainDataset(self.dir), b, shuffle=True,
                              seed=seed, prefetch=t["loader_prefetch"])

        def epochs():
            while True:
                yield from loader

        self.batches = device_prefetch(epochs(), str(ctx.device),
                                       depth=t["prefetch_depth"])

    def _step(self, i: int):
        images, labels = next(self.batches)
        return self.trainer.train_step(images, labels, i)

    def release(self) -> None:
        super().release()
        self.batches.close()
        self.batches = None
        shutil.rmtree(self.dir, ignore_errors=True)


def setup(ctx) -> Stage3Loader:
    return Stage3Loader(ctx)
