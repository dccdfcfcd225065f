"""The stage-3 CLI's per-epoch ROC and ``test_rfw --int8`` on the CPU.

* ``train_stage3`` with ``MobileFaceNet`` (one step, one epoch) and a
  verification set writes the set's ROC curve image under its log
  directory every epoch, as the JAX CLI passes ``roc=`` to
  ``log_benchmark``; where matplotlib cannot be imported it says so once
  and goes on without the image.
* ``test_rfw --int8`` on that checkpoint: the f32 accuracy of the run
  without ``--int8`` and an int8 accuracy beside it, the stripped copy's
  embeddings from the calibrated int8 path.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.tools import test_rfw, train_stage3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "stage3_bupt_ir50.json")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(root):
    rng = np.random.RandomState(0)
    for ident in ("a1", "b2"):
        (root / "faces" / ident).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.randint(0, 256, (120, 120, 3), np.uint8)
                            ).save(root / "faces" / ident / f"{j}.png")
    images = (rng.randint(0, 256, (40, 112, 112, 3)) / 127.5 - 1).astype(
        np.float32)
    images[1::4] = images[0::4]
    np.savez(root / "rfw_African.npz", images=images,
             issame=np.arange(20) % 2 == 0)


def _train(root, name):
    cfg = dict(json.load(open(CONFIG)), backbone="MobileFaceNet",
               data_root=str(root), train_subdir="faces",
               model_root=str(root / "runs"), name=name, batch_size=2,
               num_epochs=1, freeze_backbone_epochs=0, stages=[2],
               eval_benchmarks=["rfw_African"], emb_size=64)
    (root / f"{name}.json").write_text(json.dumps(cfg))
    train_stage3.main(["--config", str(root / f"{name}.json"),
                       "--max_steps", "1", "--device", "cpu",
                       "--compute_dtype", "float32"])
    return root / "runs" / name


def test_epoch_roc_image_and_test_rfw_int8(tmp_path, capsys):
    _tree(tmp_path)
    run = _train(tmp_path, "mfn")
    roc = run / "logs" / "rfw_African_ROC_Curve" / "0001.jpg"
    img = np.asarray(Image.open(roc))
    assert img.ndim == 3 and img.std() > 0
    capsys.readouterr()

    args = ["--checkpoint", str(run / "step_000000001.pt"), "--data_root",
            str(tmp_path), "--benchmarks", "rfw_African", "--backbone",
            "MobileFaceNet", "--emb_size", "64", "--batch_size", "20",
            "--device", "cpu"]
    f32 = test_rfw.main(args)
    res = test_rfw.main(args + ["--int8"])
    assert res["rfw_African"] == f32["rfw_African"]
    acc8, thr8 = res["rfw_African_int8"]
    assert 0.0 <= acc8 <= 1.0 and np.isfinite(thr8)
    out = capsys.readouterr().out
    assert "rfw_African: int8 accuracy" in out and "delta" in out


def test_epoch_roc_skipped_without_matplotlib(tmp_path, monkeypatch, capsys):
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else find_spec(name, *a))
    _tree(tmp_path)
    run = _train(tmp_path, "mfn")
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    assert not (run / "logs" / "rfw_African_ROC_Curve").exists()
    logs = [json.loads(line) for line in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert any("rfw_African_Accuracy" in line for line in logs)
    assert (run / "step_000000001.pt").exists()
