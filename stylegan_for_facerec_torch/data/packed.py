"""Packed pre-decoded training shards, their loader, and the host-to-card
prefetch, as ``stylegan_for_facerec_tpu/data/packed.py``. The layout is
the JAX package's, so either package reads what the other wrote:

  <dir>/packed_meta.json            {image_size, n_images, shard_size,
                                     n_shards, id_list}
  <dir>/shard-00000.npy             uint8 (n, S, S, 3) NHWC
  <dir>/labels.npy                  int32 (N,)

``pack_dataset`` decodes an image tree once (through ``make_loader``: the
C++ loader where it can) into shards. Shards are memory-mapped; the
trainer maps uint8 to [-1, 1] on the card.
``PackedLoader`` gives the JAX ``PackedLoader``'s batches for the same
seed and epoch. ``device_prefetch`` pins and copies batches on a producer
thread, ``depth`` ahead, on a side CUDA stream while the card runs the
current one.
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
from ..utils.tracing import count, span

META_NAME = "packed_meta.json"


def save_packed_meta(out_dir: str, image_size: int, n_images: int,
                     shard_size: int, n_shards: int, id_list) -> dict:
    meta = {"image_size": image_size, "n_images": n_images,
            "shard_size": shard_size, "n_shards": n_shards,
            "id_list": list(id_list)}
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f)
    return meta


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
    return save_packed_meta(out_dir, images.shape[1], n, shard_size,
                            n_shards, id_list)


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


def pack_dataset(dataset, out_dir: str, shard_size: int = 8192,
                 num_workers: int = 8, batch_size: int = 256,
                 progress: bool = True) -> dict:
    """Decode every image of ``dataset`` (a ``FacesDataset``) once, in
    order, and write it as uint8 shards with its labels and metadata;
    returns the metadata."""
    from .native_loader import make_loader
    os.makedirs(out_dir, exist_ok=True)
    n, s = len(dataset), dataset.image_size
    loader = make_loader(dataset, batch_size, shuffle=False,
                         num_workers=num_workers, drop_last=False)
    labels_out = np.empty((n,), np.int32)
    shard = np.empty((shard_size, s, s, 3), np.uint8)
    written = fill = shard_idx = 0      # in finished shards, in ``shard``

    def flush():
        nonlocal shard_idx, written, fill
        if fill == 0:
            return
        np.save(os.path.join(out_dir, f"shard-{shard_idx:05d}.npy"),
                shard[:fill])
        shard_idx += 1
        written += fill
        fill = 0

    for images, labels in loader:
        # the loaders give u / 127.5 - 1: inverted exactly
        u8 = np.rint((images + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        b = len(labels)
        labels_out[written + fill: written + fill + b] = labels
        off = 0
        while off < b:
            take = min(shard_size - fill, b - off)
            shard[fill: fill + take] = u8[off: off + take]
            fill += take
            off += take
            if fill == shard_size:
                flush()
        if progress and shard_idx % 8 == 0:
            print(f"[pack] {written + fill}/{n} images", flush=True)
    flush()
    if written != n:
        raise RuntimeError(f"packed {written} of {n} images")
    np.save(os.path.join(out_dir, "labels.npy"), labels_out)
    return save_packed_meta(out_dir, s, n, shard_size, shard_idx,
                            dataset.id_list)


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
    gathered ahead.

    Data parallelism: ``batch_size`` is the global batch. With
    ``num_processes > 1`` every process derives the same shuffle and
    yields the ``process_id``-th contiguous ``batch_size // num_processes``
    rows of each global batch, so together they cover it once. Under a
    ``parallel.mesh.Mesh`` ``process_id`` is the rank's data index and
    ``num_processes`` the data-axis size: the ranks of one model axis
    load the same rows."""

    def __init__(self, dataset: PackedTrainDataset, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 4, process_id: int = 0,
                 num_processes: int = 1):
        if batch_size % num_processes:
            raise ValueError(f"global batch {batch_size} does not divide "
                             f"over {num_processes} processes")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process {process_id} of {num_processes}")
        if num_processes > 1 and not drop_last:
            raise ValueError("loading over several processes needs "
                             "drop_last=True (a ragged last batch would "
                             "split unevenly)")
        self.process_id, self.num_processes = process_id, num_processes
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
        local = self.batch_size // self.num_processes
        lo = self.process_id * local

        def batches():
            for b in range(nb):
                start = b * self.batch_size + lo
                idxs = order[start:start + local]
                yield (self.ds.gather(idxs),
                       self.ds.labels[idxs].astype(np.int32))

        yield from _pumped(batches, self.prefetch,
                           "PackedLoader producer failed")


def device_prefetch(iterator, device: str = "cuda", depth: int = 2):
    """(images, labels) numpy batches -> tensors on ``device``, shipped on
    a daemon producer thread at most ``depth`` batches ahead of the
    consumer, as the JAX ``device_prefetch``. On a GPU the producer pins
    each batch on the host, copies it ``non_blocking`` on a side stream
    and records an event; the consumer's stream waits on that event
    before it sees the batch. On the CPU the arrays are wrapped as they
    are, through the same producer. A failure of the producer reaches the
    consumer as ``RuntimeError("prefetch producer failed")``, after every
    batch shipped before it. Abandoning the generator stops the producer.
    On the consumer's thread the span ``sgfr.data.wait``
    (``utils/tracing.py``) covers each wait for the next shipped batch,
    and the counter ``sgfr.data.batches`` counts the batches handed over.

    JAX's ``sharding`` has no counterpart: under data parallelism each
    rank prefetches its own ``PackedLoader`` slice onto its own card."""
    dev = resolve_device(device)
    if depth < 1:
        raise ValueError(f"depth {depth}: at least one batch ahead")
    if dev.type != "cuda":
        def wrapped():
            for batch in iterator:
                yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                            for a in batch)

        yield from _handed_over(_pumped(wrapped, depth,
                                        "prefetch producer failed"))
        return
    side = torch.cuda.Stream(dev)

    def shipped():
        # the current device and stream are the producer thread's own
        with torch.cuda.device(dev), torch.cuda.stream(side):
            for batch in iterator:
                host = [torch.from_numpy(np.ascontiguousarray(a))
                        .pin_memory() for a in batch]
                out = tuple(h.to(dev, non_blocking=True) for h in host)
                done = torch.cuda.Event()
                done.record(side)
                yield out, host, done

    def waited(item):
        # ``host``, the pinned source, lives until the wait is queued
        out, host, done = item
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in out:
            t.record_stream(consumer)
        return out

    yield from _handed_over(_pumped(shipped, depth,
                                    "prefetch producer failed"), waited)


def _handed_over(items, finish=None):
    """The items of the generator ``items`` (through ``finish``), each wait
    for the next (the queue's get and ``finish``) inside the span
    ``sgfr.data.wait``; closing this generator closes ``items``."""
    try:
        while True:
            with span("sgfr.data.wait"):
                item = next(items, None)
                if item is None:
                    return
                if finish is not None:
                    item = finish(item)
            count("sgfr.data.batches")
            yield item
    finally:
        items.close()
