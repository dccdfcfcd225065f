"""Work done once per test session and shared by the xdist workers.

Under pytest-xdist a module fixture runs on every worker that takes a test
of its file. The fixtures here run their work once a session: the first
worker to ask computes under a file lock in the session's shared temp
directory and saves the result there, and the others load it.
``shared_spawn`` runs a set of ``parallel._mp_worker`` tasks (two to four
worker processes of ~1.3 GB each); ``shared_result`` any computation whose
result ``torch.save`` can write (the fixtures that compile JAX steps)."""

import os

import numpy as np
import torch
from filelock import FileLock

from stylegan_for_facerec_torch.parallel import _mp_worker as mp


def _root(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent                 # shared by the session's workers
    return root


def shared_spawn(tmp_path_factory, name, tasks, world, **kwargs):
    """Each rank's results of ``parallel._mp_worker.spawn(tasks, world)``
    on the CPU, once a session."""
    out = _root(tmp_path_factory) / name
    return shared_result(tmp_path_factory, name, lambda: mp.spawn(
        tasks, world, str(out), device="cpu", **kwargs))


class _Array:
    """A numpy array saved as a tensor, so that the load can map it."""

    def __init__(self, t: torch.Tensor):
        self.t = t


def _pack(obj):
    if isinstance(obj, np.ndarray) and obj.dtype != object:
        if not (obj.flags.writeable and obj.flags.c_contiguous):
            obj = np.array(obj, order="C")
        return _Array(torch.from_numpy(obj))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj):
    if isinstance(obj, _Array):
        return obj.t.numpy()
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v) for v in obj)
    return obj


def shared_result(tmp_path_factory, name, compute):
    """``compute()``, once a session: every worker gets the result read
    back from the file the first one saved. Its arrays and tensors are
    mapped from that file, not copied (the stage-2 coach's comparison
    holds ~4 GB of state dicts), so the workers share one copy in the
    page cache."""
    root = _root(tmp_path_factory)
    path = root / f"{name}.pt"
    with FileLock(str(root / f"{name}.lock")):
        if not path.exists():
            tmp = root / f"{name}.pt.part"
            torch.save(_pack(compute()), tmp)
            os.replace(tmp, path)
    return _unpack(torch.load(path, weights_only=False, mmap=True))
