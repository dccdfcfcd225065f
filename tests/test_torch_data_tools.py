"""The port's data CLIs against the JAX package's root tools, on the CPU
(``--device cpu``), on small generated trees:

  * ``make_filelist``: the same file;
  * ``pack_train``: shards, labels and metadata byte-equal;
  * ``pack_rfw``: every pairs-file layout parsed as the JAX tool parses it,
    the same ``<out>.npz``, which ``test_rfw --data_root`` reads;
  * ``mtcnn_crop_align`` (square pad, detection at min_face_size 100 and
    thresholds 0.9, the ArcFace warp) on drawn faces: the same crops'
    names, their pixels within 2 levels on average 0.05 (the JAX tool's
    cv2 warp and the port's differ by a level on a few pixels, and JPEG
    re-encoding spreads that); ``square_pad`` and ``ldms_transform``
    alone against the JAX tool's;
  * ``rfw_crop_align``: ``parse_lmk_file`` equal, crops as above;
  * the stage-3 CLI: ``--randaugment`` runs the Python loader with the
    transform (and is refused on packed shards, as the JAX CLI refuses
    it), ``--fast_decode`` reaches the C++ loader, and a JPEG tree goes
    through the C++ loader.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.data import native_loader, randaugment
from stylegan_for_facerec_torch.eval.verify_runner import load_val_pair
from stylegan_for_facerec_torch.tools import (make_filelist,
                                              mtcnn_crop_align, pack_rfw,
                                              pack_train, rfw_crop_align,
                                              train_stage3)
from chip_smoke import draw_faces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "stage3_bupt_ir50.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv, monkeypatch):
    mod = _jax_tool(name, monkeypatch)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    mod.main()
    return mod


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _tree(root, n_ids=3, n=4, size=(40, 36), ext="jpg"):
    rng = np.random.RandomState(0)
    for i in range(n_ids):
        d = root / f"id{i}"
        d.mkdir(parents=True)
        for j in range(n):
            Image.fromarray(rng.randint(0, 256, size + (3,), np.uint8)).save(
                d / f"id{i}_{j:04d}.{ext}")
    return root


def test_make_filelist(tmp_path, monkeypatch):
    root = _tree(tmp_path / "imgs", ext="png")
    (root / "id0" / "notes.txt").write_text("x")
    Image.new("RGB", (4, 4)).save(root / "id1" / "x.bmp")
    names = make_filelist.main(["--in_dir", str(root), "--out_file",
                                str(tmp_path / "ours.txt")])
    _run_jax("make_filelist", ["--in_dir", str(root), "--out_file",
                               str(tmp_path / "theirs.txt")], monkeypatch)
    assert len(names) == 12
    assert _same_bytes(tmp_path / "ours.txt", tmp_path / "theirs.txt")
    make_filelist.main(["--in_dir", str(root), "--out_file",
                        str(tmp_path / "bmp.txt"), "--ext", ".bmp"])
    assert (tmp_path / "bmp.txt").read_text().strip().endswith("x.bmp")


def test_pack_train(tmp_path, monkeypatch):
    root = _tree(tmp_path / "imgs", n=5)
    meta = pack_train.main(["--root", str(root), "--out",
                            str(tmp_path / "ours"), "--image_size", "32",
                            "--shard_size", "4", "--num_workers", "2"])
    _run_jax("pack_train", ["--root", str(root), "--out",
                            str(tmp_path / "theirs"), "--image_size", "32",
                            "--shard_size", "4", "--num_workers", "2"],
             monkeypatch)
    assert meta["n_images"] == 15 and meta["n_shards"] == 4
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    for name in names:
        assert _same_bytes(tmp_path / "ours" / name,
                           tmp_path / "theirs" / name), name
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no images"):
        pack_train.main(["--root", str(tmp_path / "empty"), "--out",
                         str(tmp_path / "x")])


def test_pack_rfw(tmp_path, monkeypatch):
    root = _tree(tmp_path / "rfw", n_ids=3, n=3, size=(112, 112))
    lines = ["id0 1 2", "id1 0 1", "id0 0 id2 2", "id1 2 id2 0",
             "id0/id0_0000.jpg id1/id1_0001.jpg 0",
             "id2/id2_0001.jpg id2/id2_0002.jpg 1", ""]
    (tmp_path / "pairs.txt").write_text("\n".join(lines))
    jtool = _jax_tool("pack_rfw", monkeypatch)
    got = pack_rfw.parse_pairs(str(tmp_path / "pairs.txt"))
    assert got == jtool.parse_pairs(str(tmp_path / "pairs.txt"), str(root))
    assert [s for _, _, s in got] == [True, True, False, False, False, True]
    n = pack_rfw.main(["--pairs", str(tmp_path / "pairs.txt"),
                       "--image_root", str(root), "--out",
                       str(tmp_path / "rfw_African")])
    _run_jax("pack_rfw", ["--pairs", str(tmp_path / "pairs.txt"),
                          "--image_root", str(root), "--out",
                          str(tmp_path / "jax_African")], monkeypatch)
    assert n == 6
    images, issame = load_val_pair(str(tmp_path / "rfw_African"))
    jd = np.load(tmp_path / "jax_African.npz")
    np.testing.assert_array_equal(images, jd["images"])
    np.testing.assert_array_equal(issame, jd["issame"])
    assert images.shape == (12, 112, 112, 3) and images.dtype == np.float32


# seeds of drawn 360 x 280 faces that pass thresholds 0.9 (2, 4, 6, 7)
# and one that does not (0)
FACE_SEEDS = ((2, 4, 0), (6, 7))


def _face_tree(root, seeds=FACE_SEEDS):
    for i, row in enumerate(seeds):
        d = root / f"id{i}"
        d.mkdir(parents=True)
        for j, seed in enumerate(row):
            draw_faces(seed, 360, 280, 1, 60, 100).save(d / f"{j}.png")
    return root


def _crops(root):
    return sorted(os.path.relpath(os.path.join(p, f), root)
                  for p, _, fs in os.walk(root) for f in fs)


def _close_jpegs(a_root, b_root, names):
    worst_mean, worst = 0.0, 0
    for name in names:
        a = np.asarray(Image.open(os.path.join(a_root, name)), np.int64)
        b = np.asarray(Image.open(os.path.join(b_root, name)), np.int64)
        assert a.shape == b.shape
        d = np.abs(a - b)
        worst_mean, worst = max(worst_mean, float(d.mean())), max(
            worst, int(d.max()))
    return worst_mean, worst


def test_mtcnn_crop_align(tmp_path, monkeypatch):
    root = _face_tree(tmp_path / "photos")
    (root / "id0" / "broken.jpg").write_bytes(b"not an image")
    n = mtcnn_crop_align.main(["--in_dir", str(root), "--out_dir",
                               str(tmp_path / "ours"), "--n_threads", "2",
                               "--device", "cpu"])
    jtool = _run_jax("mtcnn_crop_align",
                     ["--in_dir", str(root), "--out_dir",
                      str(tmp_path / "theirs"), "--n_threads", "2"],
                     monkeypatch)
    names = _crops(tmp_path / "ours")
    assert n == len(names) == 4
    assert names == _crops(tmp_path / "theirs")
    mean, worst = _close_jpegs(tmp_path / "ours", tmp_path / "theirs", names)
    print(f"mtcnn_crop_align: {n} crops, mean {mean:.4f} and max {worst} "
          f"levels off the JAX tool's (tolerance 0.05 and 2)")
    assert mean <= 0.05 and worst <= 2
    for shape in ((30, 50, 3), (51, 20, 3), (16, 16, 3)):
        img = np.random.RandomState(1).randint(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(mtcnn_crop_align.square_pad(img),
                                      jtool.square_pad(img))
    img = np.asarray(Image.open(root / "id1" / "0.png"))
    # a generic similarity: at a scale of exactly 2.5 half the samples
    # would fall on pixel midpoints, where a sum within round-off of a
    # half level rounds either way
    pts = mtcnn_crop_align.ARC_SRC * 2.37 + np.array([31.3, 12.9]) \
        + np.random.RandomState(2).randn(5, 2)
    d = np.abs(mtcnn_crop_align.ldms_transform(img, pts, 112, "cpu")
               .astype(int)
               - jtool.ldms_transform(img, pts, 112).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    lst = tmp_path / "list.txt"
    lst.write_text(str(root / "id1" / "0.png") + "\n")
    assert mtcnn_crop_align.main(["--in_list", str(lst), "--out_dir",
                                  str(tmp_path / "one"), "--device",
                                  "cpu"]) == 1


def test_rfw_crop_align(tmp_path, monkeypatch):
    root = _face_tree(tmp_path / "rfw", seeds=((2, 4),))
    jtool = _jax_tool("rfw_crop_align", monkeypatch)
    base = mtcnn_crop_align.ARC_SRC * 2.0 + np.array([90.0, 40.0])
    rows = [f"/id0/{j}.png 7 " + " ".join(f"{v:.3f}" for v in
                                           (base + 3 * j).ravel())
            for j in range(2)]
    rows += ["/id0/missing.png 7 " + " ".join(["1.0"] * 10), "short line"]
    (tmp_path / "lmk.txt").write_text("\n".join(rows) + "\n")
    got = rfw_crop_align.parse_lmk_file(str(tmp_path / "lmk.txt"))
    want = jtool.parse_lmk_file(str(tmp_path / "lmk.txt"))
    assert got.keys() == want.keys() and len(got) == 3
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    n = rfw_crop_align.main(["--in_dir", str(root), "--lmk_file",
                             str(tmp_path / "lmk.txt"), "--out_dir",
                             str(tmp_path / "ours"), "--device", "cpu"])
    _run_jax("rfw_crop_align", ["--in_dir", str(root), "--lmk_file",
                                str(tmp_path / "lmk.txt"), "--out_dir",
                                str(tmp_path / "theirs")], monkeypatch)
    names = _crops(tmp_path / "ours")
    assert n == 2 and names == _crops(tmp_path / "theirs")
    mean, worst = _close_jpegs(tmp_path / "ours", tmp_path / "theirs", names)
    print(f"rfw_crop_align: mean {mean:.4f}, max {worst} levels off the JAX "
          f"tool's (tolerance 0.05 and 2)")
    assert mean <= 0.05 and worst <= 2


def _stage3_cfg(tmp_path, name, subdir="faces"):
    cfg = dict(json.load(open(CONFIG)), backbone="MobileFaceNet",
               data_root=str(tmp_path), train_subdir=subdir,
               model_root=str(tmp_path / "runs"), name=name, batch_size=2,
               num_epochs=1, stages=[2], eval_benchmarks=[], emb_size=64)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return ["--config", str(path), "--max_steps", "2", "--device", "cpu",
            "--compute_dtype", "float32"]


def test_stage3_cli_randaugment(tmp_path, monkeypatch, capsys):
    _tree(tmp_path / "faces", n_ids=2, n=3, size=(112, 112))
    calls = []
    apply = randaugment.RandAugment.apply

    def counted(self, image, draws):
        calls.append(len(draws))
        return apply(self, image, draws)

    monkeypatch.setattr(randaugment.RandAugment, "apply", counted)
    train_stage3.main(_stage3_cfg(tmp_path, "ra") + ["--randaugment", "2"])
    out = capsys.readouterr().out
    assert "RandAugment(2 ops)" in out and "through DataLoader" in out
    assert "per-image transform" in out
    assert len(calls) >= 4 and set(calls) == {2}
    assert os.path.exists(tmp_path / "runs" / "ra" / "step_000000002.pt")
    # packed shards refuse it
    pack_train.main(["--root", str(tmp_path / "faces"), "--out",
                     str(tmp_path / "packed"), "--num_workers", "1"])
    with pytest.raises(SystemExit, match="packed"):
        train_stage3.main(_stage3_cfg(tmp_path, "ra2", "packed")
                          + ["--randaugment", "2"])


def test_stage3_cli_fast_decode(tmp_path, monkeypatch, capsys):
    _tree(tmp_path / "faces", n_ids=2, n=3, size=(300, 280))
    seen = []
    init = native_loader.NativeDataLoader.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("fast_decode"))
        init(self, *a, **kw)

    monkeypatch.setattr(native_loader.NativeDataLoader, "__init__", spy)
    train_stage3.main(_stage3_cfg(tmp_path, "fd") + ["--fast_decode"])
    train_stage3.main(_stage3_cfg(tmp_path, "full"))
    assert seen == [True, False]
    assert capsys.readouterr().out.count("through NativeDataLoader") == 2
    for run in ("fd", "full"):
        ck = torch.load(tmp_path / "runs" / run / "step_000000002.pt",
                        weights_only=True)
        assert all(torch.isfinite(v).all() for v in ck["backbone"].values()
                   if v.is_floating_point())
