"""Packed pre-decoded training shards, their loader, and the host-to-card
prefetch, as ``stylegan_for_facerec_tpu/data/packed.py``. The layout is
the JAX package's, so either package reads what the other wrote:

  <dir>/packed_meta.json            {image_size, n_images, shard_size,
                                     n_shards, id_list}
  <dir>/shard-00000.npy             uint8 (n, S, S, 3) NHWC
  <dir>/labels.npy                  int32 (N,)

Shards are memory-mapped; the trainer maps uint8 to [-1, 1] on the card.
``PackedLoader`` gives the JAX ``PackedLoader``'s batches for the same
seed and epoch. ``device_prefetch`` copies batch k + 1 from pinned host
memory on a side CUDA stream while the card runs batch k.
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import threading
from typing import Iterator, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

META_NAME = "packed_meta.json"


def write_packed(out_dir: str, images: np.ndarray, labels: np.ndarray,
                 id_list, shard_size: int = 8192) -> dict:
    """Write uint8 NHWC ``images`` and integer labels as a packed
    directory; returns the metadata."""
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError("images must be uint8 NHWC")
    n = len(images)
    if len(labels) != n:
        raise ValueError(f"{len(labels)} labels for {n} images")
    os.makedirs(out_dir, exist_ok=True)
    n_shards = -(-n // shard_size)
    for i in range(n_shards):
        np.save(os.path.join(out_dir, f"shard-{i:05d}.npy"),
                images[i * shard_size: (i + 1) * shard_size])
    np.save(os.path.join(out_dir, "labels.npy"),
            np.asarray(labels, np.int32))
    meta = {"image_size": images.shape[1], "n_images": n,
            "shard_size": shard_size, "n_shards": n_shards,
            "id_list": list(id_list)}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return meta


def _pumped(make_items, maxsize: int, err_msg: str):
    """Yield the items of ``make_items()`` from a daemon producer thread
    through a bounded queue. A producer exception is raised on the
    consumer after the queued items drain; abandoning the consumer stops
    the producer."""
    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=maxsize)
    stop = object()
    abandoned = threading.Event()
    failure = []

    def producer():
        try:
            for item in make_items():
                if abandoned.is_set():
                    return
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue_mod.Full:
                        continue
        except Exception as e:  # noqa: BLE001 -- raised on the consumer
            if not abandoned.is_set():
                failure.append(e)
        finally:
            while not abandoned.is_set():
                try:
                    q.put(stop, timeout=0.5)
                    return
                except queue_mod.Full:
                    continue

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is stop:
                if failure:
                    raise RuntimeError(err_msg) from failure[0]
                return
            yield item
    finally:
        abandoned.set()


def is_packed_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, META_NAME))


class PackedTrainDataset:
    """Memory-mapped view over a packed directory."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, META_NAME)) as f:
            self.meta = json.load(f)
        self.image_size = int(self.meta["image_size"])
        self.n_images = int(self.meta["n_images"])
        self.shard_size = int(self.meta["shard_size"])
        self.id_list = list(self.meta["id_list"])
        self.n_identities = len(self.id_list)
        self.labels = np.load(os.path.join(root, "labels.npy"))
        self.shards = [
            np.load(os.path.join(root, f"shard-{i:05d}.npy"), mmap_mode="r")
            for i in range(int(self.meta["n_shards"]))]

    def __len__(self):
        return self.n_images

    def gather(self, idxs: np.ndarray) -> np.ndarray:
        """(B, S, S, 3) uint8 for global indices ``idxs``, one fancy index
        per touched shard."""
        out = np.empty((len(idxs), self.image_size, self.image_size, 3),
                       np.uint8)
        sh = idxs // self.shard_size
        off = idxs % self.shard_size
        for s in np.unique(sh):
            sel = np.nonzero(sh == s)[0]
            out[sel] = self.shards[s][off[sel]]
        return out


class PackedLoader:
    """``data.dataset.DataLoader``'s contract over packed shards: the
    epoch's order is ``RandomState(seed + epoch counter)``'s shuffle, and a
    producer thread keeps ``prefetch`` (uint8 NHWC, int32) batches
    gathered ahead."""

    def __init__(self, dataset: PackedTrainDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 4):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.RandomState(self.seed + self._epoch)
        self._epoch += 1
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng.shuffle(order)
        nb = len(self)

        def batches():
            for b in range(nb):
                idxs = order[b * self.batch_size: (b + 1) * self.batch_size]
                yield (self.ds.gather(idxs),
                       self.ds.labels[idxs].astype(np.int32))

        yield from _pumped(batches, self.prefetch,
                           "PackedLoader producer failed")


def device_prefetch(iterator, device: str = "cuda"):
    """(images, labels) numpy batches -> tensors on ``device``. On a GPU
    each batch is pinned on the host and copied ``non_blocking`` on a side
    stream one batch ahead; the consuming stream waits on the copy's event
    before it sees the batch. On the CPU the arrays are wrapped as they
    are."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        for batch in iterator:
            yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                        for a in batch)
        return
    side = torch.cuda.Stream(dev)

    def ship(batch):
        host = [torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                for a in batch]
        with torch.cuda.stream(side):
            out = tuple(h.to(dev, non_blocking=True) for h in host)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    it = iter(iterator)
    pending = next(it, None)
    pending = None if pending is None else ship(pending)
    while pending is not None:
        out, done = pending
        nxt = next(it, None)
        pending = None if nxt is None else ship(nxt)
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        yield out
