"""The port's stage-3 training CLI and RFW verification CLI on the CPU, at
the full width of the recipe's backbone (IR-SE-50 ``PSpFaceRec`` at 112
px) on a tiny image tree: 3 identities of 2 images, batch 2, 3 steps an
epoch, the body frozen in epochs 0 and 1, one RFW-format set of 10 pairs.

  * two steps from a stage-2 checkpoint of the port (``--encoder_checkpoint``:
    its input layer and body, and its average image), a checkpoint with
    the epoch's verification result, then ``--resume``;
  * a run stopped after its first step (the preemption path) and resumed:
    the resumed epoch replays the loader's permutation and skips the batch
    it had taken;
  * ``test_rfw`` on the checkpoint, which reads the same accuracy;
  * both CLIs raise without ``--device cpu`` when no GPU is found.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.data.dataset import FacesDataset
from stylegan_for_facerec_torch.data.native_loader import make_loader
from stylegan_for_facerec_torch.models.psp import PSp
from stylegan_for_facerec_torch.tools import test_rfw, train_stage3
from stylegan_for_facerec_torch.train.stage3 import Stage3Trainer
from stylegan_for_facerec_torch.utils.checkpoint import save_checkpoint

CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "stage3_bupt_ir50.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("s3")
    rng = np.random.RandomState(0)
    for ident in ("Asian^a1", "b2", "c3"):
        (root / "faces" / ident).mkdir(parents=True)
        for j in range(2):
            Image.fromarray(rng.randint(0, 256, (120, 120, 3), np.uint8)
                            ).save(root / "faces" / ident / f"{j}.png")
    # 10 pairs, one a duplicate: each of the 10 folds holds one pair
    images = (rng.randint(0, 256, (20, 112, 112, 3)) / 127.5 - 1).astype(
        np.float32)
    images[1] = images[0]
    np.savez(root / "rfw_African.npz", images=images,
             issame=np.arange(10) < 1)
    s2 = PSp(output_size=32, input_size=112)
    with torch.no_grad():
        for p in s2.encoder.parameters():
            p.add_(0.01)
    avg = torch.from_numpy(rng.uniform(-1, 1, (112, 112, 3)).astype(
        np.float32))
    save_checkpoint(str(root / "s2.pt"), s2, avg)
    body = {k: v.clone() for k, v in s2.encoder.body.state_dict().items()}
    del s2
    return root, body, avg


def _config(root, name, **kw):
    cfg = dict(json.load(open(CONFIG)),
               data_root=str(root), train_subdir="faces",
               model_root=str(root / "runs"), name=name, batch_size=2,
               num_epochs=4, freeze_backbone_epochs=1, stages=[2],
               eval_benchmarks=["rfw_African", "rfw_missing"], **kw)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _args(cfg, *extra):
    return ["--config", cfg, "--device", "cpu", "--compute_dtype",
            "float32", *extra]


def test_train_cli_handoff_checkpoint_resume_and_rfw(setup, capsys):
    root, body, avg = setup
    cfg = _config(root, "run")
    train_stage3.main(_args(cfg, "--encoder_checkpoint", str(root / "s2.pt"),
                            "--max_steps", "2"))
    run = root / "runs" / "run"
    ckpt = torch.load(run / "step_000000002.pt", weights_only=True)
    assert ckpt["metadata"] == {"epoch": 0, "step": 2}
    assert ckpt["opt_count"] == 2
    assert torch.equal(ckpt["avg_image"], avg)
    assert ckpt["head"]["weight"].shape == (3, 512)
    sd = ckpt["backbone"]
    # the frozen body is the stage-2 body, bit for bit; its BatchNorm
    # statistics moved
    for k, v in body.items():
        got = sd[f"encoder.body.{k}"]
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        assert torch.equal(got, v), k
    assert not torch.equal(sd["encoder.body.0.res_layer.0.running_mean"],
                           body["0.res_layer.0.running_mean"])
    logs = [json.loads(line) for line in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    bench = [line for line in logs if "rfw_African_Accuracy" in line]
    assert len(bench) == 1 and bench[0]["epoch"] == 0
    assert np.isfinite(logs[0]["train_loss"]) and logs[0]["lr"] == \
        pytest.approx(0.03)
    out = capsys.readouterr().out
    assert "rfw_missing.npz not found" in out

    train_stage3.main(_args(cfg, "--resume", "--max_steps", "5"))
    resumed = torch.load(run / "step_000000005.pt", weights_only=True)
    assert resumed["metadata"] == {"epoch": 1, "step": 5}
    assert resumed["opt_count"] == 4
    assert "[resume] from" in capsys.readouterr().out

    results = test_rfw.main(["--checkpoint", str(run / "step_000000002.pt"),
                             "--data_root", str(root), "--benchmarks",
                             "rfw_African", "--batch_size", "20",
                             "--device", "cpu"])
    acc, thr = results["rfw_African"]
    assert acc == pytest.approx(bench[0]["rfw_African_Accuracy"])
    assert thr == pytest.approx(bench[0]["rfw_African_Best_Threshold"])


class _StopAfterFirstCheck(threading.Event):
    """A preemption event that reads as set from its first check on."""

    def is_set(self):
        return True


def test_preempted_epoch_replays_its_permutation(setup, monkeypatch, capsys):
    root, _, _ = setup
    cfg = _config(root, "preempt", dropout=0.0)
    seen = []
    step = Stage3Trainer.train_step

    def recording(self, images, labels, *a, **kw):
        seen.append(labels.tolist())
        return step(self, images, labels, *a, **kw)

    monkeypatch.setattr(Stage3Trainer, "train_step", recording)
    monkeypatch.setattr(train_stage3, "install_preemption_handler",
                        lambda *a: _StopAfterFirstCheck())
    train_stage3.main(_args(cfg, "--no_prefetch"))
    run = root / "runs" / "preempt"
    meta = torch.load(run / "step_000000001.pt", weights_only=True,
                      mmap=True)["metadata"]
    assert meta == {"epoch": 0, "step": 1, "preempted": True,
                    "loader_epoch": 0, "loader_seed": 0}
    monkeypatch.setattr(train_stage3, "install_preemption_handler",
                        lambda *a: threading.Event())
    train_stage3.main(_args(cfg, "--resume", "--max_steps", "3"))
    assert "replaying loader permutation 0" in capsys.readouterr().out
    # the epoch's three batches, each once, in the order of the loader the
    # CLI takes (make_loader's)
    want = [y.tolist() for _, y in
            make_loader(FacesDataset(str(root / "faces")), 2, seed=0)]
    assert seen == want
    final = torch.load(run / "step_000000003.pt", weights_only=True)
    assert final["metadata"] == {"epoch": 0, "step": 3}
    assert final["opt_count"] == 3


def test_clis_refuse_a_missing_gpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    root, _, _ = setup
    cfg = _config(root, "nogpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_stage3.main(["--config", cfg])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_rfw.main(["--checkpoint", str(root / "none.pt"), "--data_root",
                       str(root)])
