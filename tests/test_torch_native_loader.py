"""The port's C++ loader (its own copy of ``fastloader.cpp``, built into
the git-ignored ``ops/build/``) against the JAX package's and against the
Python loader, on the CPU, mirroring ``tests/test_native_loader.py``:

  * port against JAX: bit-equal batches (images and labels) for the same
    seed and epochs, with and without ``fast_decode``;
  * against PIL (the Python loader): within 2.2 / 255 on the [-1, 1] scale
    (PIL rounds to uint8 after its resize, the C++ side does not); PNG
    decoded natively; 112 px sources at 112 px bit-equal with and without
    ``fast_decode``, 512 px sources at 64 px within 4 / 127.5 on average;
  * corrupt files resampled (every batch finite), an all-corrupt tree
    raising; a ragged tail trimmed as the Python loader trims it, with its
    labels (on a tree without corrupt files: a replacement's label depends
    on the worker thread that drew it); epochs reshuffled; no deadlock
    over repeated epochs;
  * ``make_loader``'s routes to the Python loader (no library, a file
    neither JPEG nor PNG, PNG on a JPEG-only build, a transform), each
    printed;
  * the build cache keyed on a hash of the source and one of the host, in
    ``ops/build/``.
"""

import hashlib
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.data import FacesDataset as JFacesDataset
from stylegan_for_facerec_tpu.data import native_loader as jnative
from stylegan_for_facerec_torch.data import native_loader
from stylegan_for_facerec_torch.data.dataset import DataLoader, FacesDataset

PIL_TOL = 1.1 / 255 * 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    lib = native_loader._get_lib()
    assert lib is not None, native_loader.status()
    return lib


def _tree(root, n_ids=2, n=10, size=112, ext="jpg", seed=0):
    rng = np.random.RandomState(seed)
    for ident in range(n_ids):
        d = root / f"id{ident}"
        d.mkdir(parents=True)
        for i in range(n):
            arr = rng.randint(0, 256, (size, size, 3), np.uint8)
            Image.fromarray(arr).save(d / f"{i}.{ext}", quality=95)
    return str(root)


@pytest.fixture()
def faces_root(tmp_path):
    root = _tree(tmp_path / "faces")
    (tmp_path / "faces" / "id0" / "zz_bad.jpg").write_bytes(b"not a jpeg")
    return root


def _big_tree(root):
    """512 px smooth JPEGs (a DCT-scaled decode's error stays small)."""
    d = root / "id0"
    d.mkdir(parents=True)
    yy, xx = np.mgrid[0:512, 0:512] / 511.0
    for i in range(4):
        arr = np.stack([np.sin(3 * xx + i), np.cos(2 * yy), xx * yy], -1)
        arr = (arr - arr.min()) / (arr.max() - arr.min()) * 255
        Image.fromarray(arr.astype(np.uint8)).save(d / f"{i}.jpg", quality=95)
    return str(root)


@pytest.mark.parametrize("fast_decode", [False, True])
def test_bit_equal_to_the_jax_packages(lib, tmp_path, fast_decode):
    root = _tree(tmp_path / "faces", n_ids=3, n=7, size=150)
    big = _big_tree(tmp_path / "big")
    for path, size in ((root, 128), (big, 64)):
        kw = dict(batch_size=4, shuffle=True, num_workers=3, seed=5,
                  drop_last=False, fast_decode=fast_decode)
        ours = native_loader.NativeDataLoader(FacesDataset(path, size), **kw)
        theirs = jnative.NativeDataLoader(JFacesDataset(path, size), **kw)
        for _ in range(2):                       # two epochs
            a, b = list(ours), list(theirs)
            assert len(a) == len(b) == len(ours)
            for (xa, ya), (xb, yb) in zip(a, b):
                np.testing.assert_array_equal(xa, xb)
                np.testing.assert_array_equal(ya, yb)


def test_matches_pil_and_resamples_corrupt(lib, faces_root):
    ds = FacesDataset(faces_root)
    imgs, labels = next(iter(native_loader.NativeDataLoader(
        ds, batch_size=4, shuffle=False, num_workers=3)))
    worst = 0.0
    for j in range(4):
        ref = ds.load(j)
        worst = max(worst, float(np.abs(imgs[j] - ref[0]).max()))
        assert labels[j] == ref[1]
    print(f"native vs PIL: {worst:.4f} (tolerance {PIL_TOL:.4f})")
    assert worst <= PIL_TOL
    dl = native_loader.NativeDataLoader(ds, batch_size=7, shuffle=True,
                                        num_workers=4, seed=3)
    e1 = [y.copy() for _, y in dl]
    e2 = [y.copy() for _, y in dl]
    assert len(e1) == len(e2) == len(ds) // 7
    assert any(not np.array_equal(a, b) for a, b in zip(e1, e2))
    for imgs, _ in dl:
        assert np.isfinite(imgs).all() and imgs.min() >= -1 \
            and imgs.max() <= 1


def test_png_natively(lib, tmp_path):
    root = _tree(tmp_path / "png", n_ids=2, n=3, ext="png")
    ds = FacesDataset(root)
    dl = native_loader.make_loader(ds, batch_size=3, shuffle=False,
                                   num_workers=2)
    assert isinstance(dl, native_loader.NativeDataLoader)
    seen = 0
    for imgs, _ in dl:
        for j in range(len(imgs)):
            assert np.abs(imgs[j] - ds.load(seen + j)[0]).max() <= PIL_TOL
        seen += len(imgs)
    assert seen == len(ds)
    # at the source's size nothing is resampled: PIL's pixels exactly
    same = FacesDataset(root, image_size=112)
    imgs, _ = next(iter(native_loader.NativeDataLoader(
        same, batch_size=6, shuffle=False, num_workers=2)))
    np.testing.assert_array_equal(
        imgs, np.stack([same.load(i)[0] for i in range(6)]))


def test_ragged_tail_as_python(lib, tmp_path):
    # no corrupt file here: the C++ loader's replacement for one depends
    # on which worker thread takes its batch, so its label is not
    # reproducible run to run, nor equal to the Python loader's
    ds = FacesDataset(_tree(tmp_path / "faces"))
    assert len(ds) % 8
    nb = [(x.shape[0], y.copy()) for x, y in native_loader.NativeDataLoader(
        ds, batch_size=8, shuffle=False, num_workers=2, drop_last=False)]
    pb = [(x.shape[0], y) for x, y in DataLoader(ds, batch_size=8,
                                                  shuffle=False,
                                                  drop_last=False)]
    assert [c for c, _ in nb] == [c for c, _ in pb]
    assert nb[-1][0] == len(ds) % 8
    for (_, a), (_, b) in zip(nb, pb):
        np.testing.assert_array_equal(a, b)


def test_all_corrupt_raises(lib, tmp_path):
    d = tmp_path / "bad" / "id0"
    d.mkdir(parents=True)
    for i in range(4):
        (d / f"{i}.jpg").write_bytes(b"definitely not a jpeg")
    dl = native_loader.NativeDataLoader(FacesDataset(str(tmp_path / "bad")),
                                        batch_size=2, shuffle=False,
                                        num_workers=1)
    with pytest.raises(RuntimeError, match="corrupt"):
        list(dl)


def test_many_epochs(lib, faces_root):
    ds = FacesDataset(faces_root)
    dl = native_loader.NativeDataLoader(ds, batch_size=5, shuffle=True,
                                        num_workers=5, seed=11)
    for _ in range(6):
        n = 0
        for imgs, _ in dl:
            assert np.isfinite(imgs).all()
            n += 1
        assert n == len(ds) // 5


def test_fast_decode(lib, faces_root, tmp_path):
    ds = FacesDataset(faces_root, image_size=112)   # 112 px sources
    kw = dict(batch_size=4, shuffle=False, num_workers=2)
    a = next(iter(native_loader.NativeDataLoader(ds, **kw)))
    b = next(iter(native_loader.NativeDataLoader(ds, fast_decode=True,
                                                 **kw)))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    big = FacesDataset(_big_tree(tmp_path / "big"), image_size=64)
    kw["drop_last"] = False
    slow = next(iter(native_loader.NativeDataLoader(big, **kw)))
    fast = next(iter(native_loader.NativeDataLoader(big, fast_decode=True,
                                                    **kw)))
    np.testing.assert_array_equal(slow[1], fast[1])
    dev = float(np.abs(slow[0] - fast[0]).mean())
    print(f"fast_decode 512 -> 64 px: mean {dev:.4f} (tolerance "
          f"{4 / 127.5:.4f})")
    assert 0 < dev < 4 / 127.5


def test_make_loader_routes(tmp_path, monkeypatch, capsys):
    root = _tree(tmp_path / "faces", n_ids=1, n=4, size=32)
    ds = FacesDataset(root, image_size=32)
    monkeypatch.setattr(native_loader, "_get_lib", lambda: None)
    monkeypatch.setattr(native_loader, "_failure", "g++ build failed: x")
    dl = native_loader.make_loader(ds, batch_size=2, fast_decode=True)
    assert type(dl) is DataLoader
    assert "g++ build failed" in capsys.readouterr().out
    monkeypatch.undo()

    bmp = tmp_path / "bmp" / "a"
    bmp.mkdir(parents=True)
    for i in range(4):
        Image.new("RGB", (16, 16), (i, 0, 0)).save(bmp / f"{i}.bmp")
    dsb = FacesDataset(str(tmp_path / "bmp"), extensions=(".bmp",))
    assert len(dsb) == 4
    assert type(native_loader.make_loader(dsb, batch_size=2)) is DataLoader
    assert "neither JPEG nor PNG" in capsys.readouterr().out

    class NoPngLib:
        def fl_has_png(self):
            return 0

    Image.new("RGB", (32, 32)).save(tmp_path / "faces" / "id0" / "x.png")
    monkeypatch.setattr(native_loader, "_get_lib", lambda: NoPngLib())
    assert type(native_loader.make_loader(FacesDataset(root, 32),
                                          batch_size=2)) is DataLoader
    assert "JPEG-only build" in capsys.readouterr().out
    monkeypatch.undo()

    dst = FacesDataset(root, 32, transform=lambda a: a)
    assert type(native_loader.make_loader(dst, batch_size=2)) is DataLoader
    assert "transform" in capsys.readouterr().out


def test_build_cache_keyed_on_source_hash(tmp_path, monkeypatch):
    assert os.path.samefile(
        native_loader._CACHE,
        os.path.join(os.path.dirname(native_loader.__file__), "..", "ops",
                     "build"))
    monkeypatch.setattr(native_loader, "_CACHE", str(tmp_path / "cache"))
    so = native_loader._build_library()
    assert so is not None and os.path.dirname(so) == str(tmp_path / "cache")
    with open(native_loader._SRC, "rb") as f:
        src = f.read()
    assert os.path.basename(so) == (
        f"libfastloader-{hashlib.sha1(src).hexdigest()[:12]}-"
        f"{native_loader._host_tag()}.so")
    assert native_loader._build_library() == so          # cached
    # a library built on another host (CPU, g++ or libraries) is not reused
    host_tag = native_loader._host_tag
    monkeypatch.setattr(native_loader, "_host_tag", lambda: "otherhost000")
    so1 = native_loader._build_library()
    assert so1 != so and so1.endswith("-otherhost000.so")
    monkeypatch.setattr(native_loader, "_host_tag", host_tag)
    # a changed source gets its own library
    changed = tmp_path / "fastloader.cpp"
    changed.write_bytes(src + b"\n// changed\n")
    monkeypatch.setattr(native_loader, "_SRC", str(changed))
    so2 = native_loader._build_library()
    assert so2 != so and os.path.exists(so) and os.path.exists(so2)
    assert not [f for f in os.listdir(tmp_path / "cache")
                if f.endswith(".tmp")]
