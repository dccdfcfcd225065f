"""``utils/checkpoint.py::resolve_checkpoint_dir`` and the eval CLIs on a
training run directory.

* On the JAX package's layouts (a checkpoint directory with
  ``manifest.json``, a run root with two ``step_*/``, a run root with
  ``best/`` only, an empty directory, a file, a missing path) the port
  resolves every path as JAX's ``resolve_checkpoint_dir`` does.
* On this package's layout (``CheckpointManager``'s ``step_*.pt`` and
  ``best.pt``) a run root goes to its newest step, else to ``best.pt``; a
  write left in flight (``.tmp``) is passed over.
* ``load_backbone``, ``load_metadata`` and ``load_checkpoint`` on a run
  root load its newest step; ``test_rfw``, ``test_rb_webface``,
  ``export_model``'s embedder loader and ``inference_iterative`` (with the
  run's ``avg_image.npy``) take a run root.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.utils import checkpoint as jckpt
from stylegan_for_facerec_torch.models.mobilefacenet import MobileFaceNet
from stylegan_for_facerec_torch.models.psp import build_psp
from stylegan_for_facerec_torch.tools import (export_model,
                                              inference_iterative,
                                              test_rb_webface, test_rfw)
from stylegan_for_facerec_torch.utils import checkpoint as ckpt
from test_torch_backbone_zoo import seeded


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_dir(path):
    ckpt.write_jax_checkpoint(str(path), {"w": np.zeros(2, np.float32)})


def _jax_layouts(root):
    """name -> path of each JAX-layout case."""
    _jax_dir(root / "manifest_dir")
    for s in (3, 12):
        _jax_dir(root / "run" / f"step_{s:09d}")
    _jax_dir(root / "run" / "best")
    _jax_dir(root / "best_only" / "best")
    (root / "best_only" / "logs").mkdir()
    (root / "empty").mkdir()
    (root / "file.npz").write_bytes(b"x")
    return {name: str(root / name) for name in (
        "manifest_dir", "run", "best_only", "empty", "file.npz",
        "missing")}


@pytest.mark.parametrize("case", ("manifest_dir", "run", "best_only",
                                  "empty", "file.npz", "missing"))
def test_jax_layouts_resolve_as_in_jax(tmp_path, case):
    path = _jax_layouts(tmp_path)[case]
    got = ckpt.resolve_checkpoint_dir(path)
    assert got == jckpt.resolve_checkpoint_dir(path)
    want = {"run": os.path.join(path, "step_000000012"),
            "best_only": os.path.join(path, "best")}.get(case, path)
    assert got == want


def test_port_layouts(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    mgr.save(3, {"x": torch.tensor(3)}, metric=2.0)
    mgr.save(12, {"x": torch.tensor(12)}, metric=1.0)
    (tmp_path / "run" / "step_000000020.pt.77.tmp").write_bytes(b"")
    run = str(tmp_path / "run")
    assert ckpt.resolve_checkpoint_dir(run) == mgr.step_path(12)
    assert ckpt.resolve_checkpoint_dir(mgr.step_path(3)) == mgr.step_path(3)
    assert ckpt.load_metadata(run)["step"] == 12
    best_only = tmp_path / "best_only"
    best_only.mkdir()
    os.replace(os.path.join(run, "best.pt"), best_only / "best.pt")
    assert ckpt.resolve_checkpoint_dir(str(best_only)) == str(
        best_only / "best.pt")
    assert ckpt.load_metadata(str(best_only))["step"] == 12
    with pytest.raises(SystemExit, match="manifest"):
        ckpt.read_jax_checkpoint(run)


@pytest.fixture(scope="module")
def stage3_run(tmp_path_factory):
    """A stage-3 run directory of two steps of a MobileFaceNet(64), each
    with other seeded weights, an RFW-style pair set and an RB-WebFace
    partition."""
    root = tmp_path_factory.mktemp("s3run")
    mgr = ckpt.CheckpointManager(str(root / "run"))
    models = {}
    for step, seed in ((1, 3), (2, 4)):
        m = seeded(MobileFaceNet(embedding_size=64), seed).eval()
        mgr.save(step, {"backbone": m.state_dict()}, metadata={"epoch": 0})
        models[step] = m
    rng = np.random.RandomState(7)
    images = (rng.randint(0, 256, (40, 112, 112, 3)) / 127.5 - 1).astype(
        np.float32)
    images[1::4] = images[0::4]
    np.savez(root / "rfw_African.npz", images=images,
             issame=np.arange(20) % 2 == 0)
    (root / "lists").mkdir()
    (root / "images" / "African").mkdir(parents=True)
    pos, neg = [], []
    for ident in range(2):
        base = rng.randint(0, 256, (120, 120, 3))
        for j in range(3):
            name = f"African/id{ident}_{j}.png"
            Image.fromarray(np.clip(base + rng.randint(-60, 61, base.shape),
                                    0, 255).astype(np.uint8)).save(
                root / "images" / name)
            pos.append(name)
    for j in range(4):
        name = f"African/neg{j}.png"
        Image.fromarray(rng.randint(0, 256, (120, 120, 3)).astype(
            np.uint8)).save(root / "images" / name)
        neg.append(name)
    (root / "lists" / "pos_pairs_samples_African.txt").write_text(
        "\n".join(pos))
    (root / "lists" / "neg_pairs_samples_African.txt").write_text(
        "\n".join(neg))
    return root, mgr, models


def test_load_backbone_on_a_run_root_is_its_newest_step(stage3_run):
    root, mgr, models = stage3_run
    got = MobileFaceNet(embedding_size=64)
    ckpt.load_backbone(str(root / "run"), got)
    for k, v in models[2].state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert not torch.equal(models[1].state_dict()["linear.weight"],
                           models[2].state_dict()["linear.weight"])


def test_eval_clis_take_a_run_directory(stage3_run):
    """Each CLI reaches its checkpoint through ``load_backbone``
    (``test_rfw``, ``test_rb_webface``) or ``export_model.load_embedder``,
    where a run directory raised ``IsADirectoryError`` before."""
    root, mgr, models = stage3_run
    common = ["--checkpoint", str(root / "run"), "--backbone",
              "MobileFaceNet", "--emb_size", "64", "--device", "cpu"]
    got = test_rfw.main(["--data_root", str(root), "--benchmarks",
                         "rfw_African", "--batch_size", "20", "--no_tta",
                         *common])
    assert 0.0 <= got["rfw_African"][0] <= 1.0
    got = test_rb_webface.main(["--data_path", str(root / "images"),
                                "--partition_path", str(root / "lists"),
                                "--batch_size", "8", "--groups", "African",
                                *common])
    assert 0.0 <= got["African"]["tpr_at_fpr_1e3"] <= 1.0
    model = MobileFaceNet(embedding_size=64)
    assert export_model.load_embedder(model, str(root / "run")) == \
        "stage-3 checkpoint"
    for k, v in models[2].state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_inversion_cli_takes_a_run_directory(tmp_path, capsys):
    """A stage-2 run directory (CheckpointManager files) with its
    avg_image.npy beside them: the newest step (a PSp; the older one is
    no PSp checkpoint at all, so loading it would raise) and that image
    load through ``load_checkpoint``."""
    model = build_psp(output_size=32, input_size=112, seed=1, device="cpu",
                      n_latent=64)
    mgr = ckpt.CheckpointManager(str(tmp_path / "run"))
    mgr.save(1, {"x": torch.zeros(1)})
    mgr.save(2, {"state_dict": model.state_dict(),
                 "latent_avg": model.latent_avg})
    run = str(tmp_path / "run")
    np.save(os.path.join(run, "avg_image.npy"), np.zeros((112, 112, 3),
                                                         np.float32))

    data = tmp_path / "faces"
    data.mkdir()
    Image.fromarray(np.random.RandomState(4).randint(
        0, 255, (40, 40, 3), np.uint8)).save(data / "img0.png")
    capsys.readouterr()
    inference_iterative.main([
        "--checkpoint_path", run, "--data_path", str(data), "--exp_dir",
        str(tmp_path / "out"), "--n_iters_per_batch", "1",
        "--test_batch_size", "1", "--output_size", "32", "--save_latents",
        "--device", "cpu"])
    said = capsys.readouterr().out
    assert f"avg image from {os.path.join(run, 'avg_image.npy')}" in said
    lats = np.load(tmp_path / "out" / "latents.npy",
                   allow_pickle=True).item()["img0"]
    assert lats.shape == (1, 10, 512) and np.isfinite(lats).all()
    shutil.rmtree(run)                  # ~0.5 GB of PSp weights
