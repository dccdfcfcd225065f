"""The port's host data modules against the JAX package's, on the CPU:

  * ``RandAugment``: every one of the 13 operations at every magnitude
    index and both signs gives the JAX ``_apply``'s image exactly; whole
    calls fed the port's draws (the JAX version's global ``np.random`` and
    ``random`` replaced by them) give identical images; a seeded
    ``random.Random`` repeats its images and the global generators are
    not touched; a transform set on ``FacesDataset`` applies before the
    resize, as in the JAX package;
  * the registry: the same dataset and model entries, transforms and
    ``make_datasets`` pairs, the MTCNN entries naming the port's copies of
    the weights;
  * ``pack_dataset``: shards, labels and metadata byte-equal to the JAX
    package's on the same tree (through the C++ loader and through the
    Python one), read back by ``PackedTrainDataset``.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.data import FacesDataset as JFacesDataset
from stylegan_for_facerec_tpu.data import packed as jpacked
from stylegan_for_facerec_tpu.data import randaugment as jra
from stylegan_for_facerec_tpu.data import registry as jregistry
from stylegan_for_facerec_torch.data import (FacesDataset, PackedTrainDataset,
                                             native_loader, pack_dataset,
                                             randaugment, registry)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Sign:
    """Stands in for the ``random`` module the JAX ``_apply`` draws its
    sign from."""

    def __init__(self, signs):
        self.signs = list(signs)

    def choice(self, seq):
        return self.signs.pop(0)


def _image(seed, h=37, w=45):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("op", randaugment.OPS)
def test_each_op_as_jax(op, monkeypatch):
    img = Image.fromarray(_image(1))
    ranges = randaugment.magnitude_ranges()
    jaug = jra.RandAugment()
    for m in range(10):
        for sign in (-1, 1):
            monkeypatch.setattr(jra, "random", _Sign([sign]))
            want = np.asarray(jaug._apply(img, op, jaug.ranges[op][m]))
            got = np.asarray(randaugment.apply_op(img, op, ranges[op][m],
                                                  sign))
            np.testing.assert_array_equal(got, want)


def test_calls_as_jax_given_the_draws(monkeypatch):
    aug = randaugment.RandAugment(num_ops=4, rng=random.Random(3))
    jaug = jra.RandAugment(num_ops=4)
    seen = set()
    for i in range(12):
        draws = aug.draw()
        seen.update(op for op, _, _ in draws)
        monkeypatch.setattr(jra.np.random, "randint",
                            lambda lo, hi, n: np.array([m for _, m, _ in
                                                        draws]))
        monkeypatch.setattr(jra.np.random, "choice",
                            lambda ops, n: np.array([op for op, _, _ in
                                                     draws]))
        monkeypatch.setattr(jra, "random", _Sign(s for _, _, s in draws))
        img = _image(10 + i)
        np.testing.assert_array_equal(aug.apply(img, draws), jaug(img))
        monkeypatch.undo()
    assert len(seen) >= 10


def test_seeded_and_private():
    state, np_state = random.getstate(), np.random.get_state()
    img = _image(2)
    a = [randaugment.RandAugment(seed=7)(img) for _ in range(2)]
    b = randaugment.RandAugment(seed=7)
    assert np.array_equal(a[0], a[1]) and np.array_equal(a[0], b(img))
    assert len({b(img).tobytes() for _ in range(4)}) > 1
    assert random.getstate() == state
    np.testing.assert_array_equal(np.random.get_state()[1], np_state[1])
    assert b.num_ops == len(randaugment.OPS) // 2 and b.max_magnitude == 10


def test_dataset_transform_as_jax(tmp_path):
    root = tmp_path / "faces" / "a"
    root.mkdir(parents=True)
    Image.fromarray(_image(3, 50, 40)).save(root / "0.png")
    flip = lambda a: a[:, ::-1]                     # noqa: E731
    got = FacesDataset(str(tmp_path / "faces"), 32, transform=flip).load(0)
    want = JFacesDataset(str(tmp_path / "faces"), 32, transform=flip).load(0)
    np.testing.assert_array_equal(got[0], want[0])
    assert not np.array_equal(got[0], FacesDataset(
        str(tmp_path / "faces"), 32).load(0)[0])


def test_registry_as_jax(tmp_path):
    assert registry.DATASET_PATHS == jregistry.DATASET_PATHS
    assert set(registry.MODEL_PATHS) == set(jregistry.MODEL_PATHS)
    for k, v in registry.MODEL_PATHS.items():
        if k.startswith("mtcnn_"):
            name = os.path.basename(v)
            assert os.path.isfile(v) and name == os.path.basename(
                jregistry.MODEL_PATHS[k])
            assert "stylegan_for_facerec_torch" in os.path.abspath(v)
        else:
            assert v == jregistry.MODEL_PATHS[k]
    assert set(registry.DATASETS) == set(jregistry.DATASETS)
    for name, cfg in registry.DATASETS.items():
        jcfg = jregistry.DATASETS[name]
        assert dict(cfg, transforms=None) == dict(jcfg, transforms=None)
        assert vars(cfg["transforms"]) == vars(jcfg["transforms"])
    for d in ("src", "tgt"):
        (tmp_path / d).mkdir()
        for i in range(2):
            Image.fromarray(_image(i, 20, 20)).save(tmp_path / d / f"{i}.png")
    paths = dict(registry.DATASETS["cars_encode"],
                 train_source_root=str(tmp_path / "src"),
                 train_target_root=str(tmp_path / "tgt"),
                 test_source_root=str(tmp_path / "src"),
                 test_target_root=str(tmp_path / "src"))
    orig = registry.DATASETS["cars_encode"]
    registry.DATASETS["cars_encode"] = paths
    try:
        train, test = registry.make_datasets("cars_encode")
    finally:
        registry.DATASETS["cars_encode"] = orig
    assert len(train) == len(test) == 2
    assert train.target_size == 192 and train.source_size is None
    with pytest.raises(KeyError):
        registry.make_datasets("nope")


def _faces(root, n_ids=3, n=7):
    rng = np.random.RandomState(9)
    for i in range(n_ids):
        d = root / f"Asian^id{i}"
        d.mkdir(parents=True)
        for j in range(n + i):
            Image.fromarray(rng.randint(0, 256, (60, 50, 3), np.uint8)).save(
                d / f"{j}.jpg", quality=90)
    return str(root)


@pytest.mark.parametrize("native", [True, False])
def test_pack_dataset_byte_equal(tmp_path, monkeypatch, native):
    root = _faces(tmp_path / "faces")
    if not native:
        # the Python loader on both sides
        monkeypatch.setattr(native_loader, "_get_lib", lambda: None)
        from stylegan_for_facerec_tpu.data import native_loader as jnl
        monkeypatch.setattr(jnl, "_get_lib", lambda: None)
    ours = pack_dataset(FacesDataset(root, 32), str(tmp_path / "ours"),
                        shard_size=8, num_workers=2, batch_size=5,
                        progress=False)
    theirs = jpacked.pack_dataset(JFacesDataset(root, 32),
                                  str(tmp_path / "theirs"), shard_size=8,
                                  num_workers=2, batch_size=5,
                                  progress=False)
    assert ours == theirs and ours["n_shards"] == 3
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    for name in names:
        with open(tmp_path / "ours" / name, "rb") as a, \
                open(tmp_path / "theirs" / name, "rb") as b:
            assert a.read() == b.read(), name
    ds = PackedTrainDataset(str(tmp_path / "ours"))
    assert len(ds) == 24 and ds.id_list == ["id0", "id1", "id2"]
    imgs, labels = next(iter(native_loader.make_loader(
        FacesDataset(root, 32), 24, shuffle=False, drop_last=False)))
    assert type(native_loader.make_loader(FacesDataset(root, 32), 2)) \
        is (native_loader.NativeDataLoader if native
            else native_loader.DataLoader)
    np.testing.assert_array_equal(ds.gather(np.arange(24)),
                                  np.rint((imgs + 1) * 127.5))
    np.testing.assert_array_equal(ds.labels, labels)
