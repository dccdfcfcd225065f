"""``data/packed.py::device_prefetch`` holds the JAX contract on the CPU:
the JAX package's two prefetch tests (``tests/test_packed_data.py``)
ported, at ``depth`` 1, 2 and 4, beside the JAX function on the same
batches.

* The batches come through in order, as tensors equal to the arrays.
* A failure of the producer reaches the consumer as
  ``RuntimeError("prefetch producer failed")`` from the original, only
  after every batch shipped before it (the batch before the failure
  included), where the JAX function raises the same.
* The producer runs at most ``depth`` batches ahead, on a thread of its
  own, and is gone within 2 s of the consumer abandoning the generator.
"""

import threading
import time

import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.data import packed as jpacked
from stylegan_for_facerec_torch.data.packed import device_prefetch

DEPTHS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (2, 4, 4, 3)).astype(np.uint8),
             rng.randint(0, 9, 2).astype(np.int32)) for _ in range(n)]


def _failing(batches, exc=ValueError("decode exploded")):
    yield from batches
    raise exc


@pytest.mark.parametrize("depth", DEPTHS)
def test_passthrough(depth):
    batches = _batches(7, seed=depth)
    out = list(device_prefetch(iter(batches), "cpu", depth=depth))
    assert len(out) == len(batches)
    for (imgs, labs), (wi, wl) in zip(out, batches):
        assert isinstance(imgs, torch.Tensor) and imgs.dtype == torch.uint8
        assert labs.dtype == torch.int32
        np.testing.assert_array_equal(imgs.numpy(), wi)
        np.testing.assert_array_equal(labs.numpy(), wl)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("k", (0, 1, 5))
def test_failure_after_the_queued_batches(depth, k):
    """k batches, then the failure: all k arrive first, as in JAX."""
    batches = _batches(k, seed=10 + k)
    got = []
    it = device_prefetch(_failing(batches), "cpu", depth=depth)
    with pytest.raises(RuntimeError, match="prefetch producer failed") as e:
        for x, y in it:
            got.append((x.numpy(), y.numpy()))
    assert isinstance(e.value.__cause__, ValueError)
    assert str(e.value.__cause__) == "decode exploded"
    assert len(got) == k
    for (x, y), (wx, wy) in zip(got, batches):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)

    # the JAX function delivers the same batches, then the same error
    import jax
    jgot = []
    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        for x, y in jpacked.device_prefetch(_failing(batches), depth=depth):
            jgot.append(np.asarray(jax.device_get(x)))
    assert len(jgot) == k
    for a, (x, _) in zip(jgot, got):
        np.testing.assert_array_equal(a, x)


def test_first_failure_is_raised_after_next():
    """JAX's ``test_device_prefetch_propagates_errors``, ported."""
    def bad():
        yield (np.zeros((1, 2, 2, 3), np.uint8), np.zeros(1, np.int32))
        raise ValueError("decode exploded")
    it = device_prefetch(bad(), "cpu", depth=2)
    next(it)
    with pytest.raises(RuntimeError, match="prefetch producer failed"):
        list(it)


def _producers():
    return {t for t in threading.enumerate() if t.daemon and t.is_alive()}


@pytest.mark.parametrize("depth", DEPTHS)
def test_producer_runs_at_most_depth_ahead_and_stops(depth):
    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield (np.full((1, 2, 2, 3), i % 256, np.uint8),
                   np.asarray([i], np.int32))
            i += 1

    before = _producers()
    it = device_prefetch(endless(), "cpu", depth=depth)
    x, y = next(it)
    assert int(y[0]) == 0
    time.sleep(0.3)
    # one batch taken, ``depth`` queued, one in the producer's hand
    assert len(pulled) <= 1 + depth + 1, (depth, len(pulled))
    started = _producers() - before
    assert started, "no producer thread"
    it.close()
    deadline = time.monotonic() + 2.0
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not any(t.is_alive() for t in started)
    n = len(pulled)
    time.sleep(0.1)
    assert len(pulled) == n


def test_depth_below_one_is_refused():
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch(iter(_batches(1)), "cpu", depth=0))
