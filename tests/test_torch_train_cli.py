"""The port's stage-2 training CLI and its host-side helpers on the CPU:
two steps over a tiny PNG folder, a checkpoint, ``--resume``; the
checkpoint manager, the metric logger, the paired dataset, ``face_grid``
and the preemption handler."""

import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.data.images_dataset import ImagesDataset
from stylegan_for_facerec_torch.eval.inference import face_grid
from stylegan_for_facerec_torch.models.psp import PSp
from stylegan_for_facerec_torch.tools import train_stage2
from stylegan_for_facerec_torch.utils.checkpoint import (CheckpointManager,
                                                         load_checkpoint,
                                                         load_metadata)
from stylegan_for_facerec_torch.utils.logging import (AverageMeter,
                                                      MetricLogger,
                                                      aggregate_loss_dicts)
from stylegan_for_facerec_torch.utils.preempt import \
    install_preemption_handler


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores, and
    torch's thread pool contending with them slows small kernels by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _faces(d, n=4, size=40):
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            d / f"img{i}.png")
    return d


def _args(data, exp, *extra):
    return ["--source_root", str(data), "--exp_dir", str(exp),
            "--output_size", "32", "--batch_size", "2", "--image_interval",
            "1", "--device", "cpu", "--allow_random_lpips", *extra]


@pytest.fixture()
def run_dir(tmp_path):
    """A stage-2 checkpoint holds the IR-SE-50 encoder with 10 style heads
    and its Ranger state (~1.8 GB): removed as soon as the test ends."""
    exp = tmp_path / "run"
    yield exp
    shutil.rmtree(exp, ignore_errors=True)


def test_train_cli_two_steps_checkpoint_and_resume(tmp_path, run_dir):
    data, exp = _faces(tmp_path / "faces"), run_dir
    train_stage2.main(_args(data, exp, "--max_steps", "2"))
    assert sorted(p.name for p in exp.glob("*.pt")) == ["step_000000001.pt"]
    ckpt = exp / "step_000000001.pt"
    assert ckpt.exists() and (exp / "avg_image.npy").exists()
    assert load_metadata(str(ckpt))["step"] == 1
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert saved["optimizer"]["state"][0]["step"] == 2
    assert saved["avg_image"].shape == (112, 112, 3)
    # a stage-2 checkpoint is an inversion checkpoint too
    model = PSp(output_size=32)
    avg = load_checkpoint(str(ckpt), model)
    assert torch.equal(avg, saved["avg_image"])
    logs = [json.loads(line) for line in
            (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert logs[0]["step"] == 0 and np.isfinite(logs[0]["train/loss"])
    assert "train/loss_lpips" in logs[0]
    assert (exp / "logs" / "images" / "train" / "faces" / "0001.jpg").exists()

    del saved["optimizer"]      # 1.3 GB of Ranger state, no longer needed
    train_stage2.main(_args(data, exp, "--max_steps", "3", "--resume"))
    resumed = torch.load(exp / "step_000000002.pt", map_location="cpu",
                         weights_only=True)
    assert resumed["optimizer"]["state"][0]["step"] == 3
    assert torch.equal(resumed["latent_avg"], saved["latent_avg"])
    enc = "encoder.input_layer.0.weight"
    assert not torch.equal(resumed["state_dict"][enc],
                           saved["state_dict"][enc])
    dec = "decoder.synthesis.first_block.conv1.weight"
    assert torch.equal(resumed["state_dict"][dec], saved["state_dict"][dec])


def test_train_cli_refuses_random_lpips_and_missing_gpu(tmp_path):
    data = _faces(tmp_path / "faces", n=2)
    args = _args(data, tmp_path / "run", "--max_steps", "1")
    args.remove("--allow_random_lpips")
    with pytest.raises(SystemExit, match="lpips_weights"):
        train_stage2.main(args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_stage2.main(args[:-2] + ["--device", "cuda"])


def test_checkpoint_manager_keeps_newest_and_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step, metric in ((1, 3.0), (2, 1.0), (3, 2.0)):
        mgr.save(step, {"x": torch.tensor(step)}, metric=metric)
    assert sorted(os.listdir(tmp_path)) == [
        "best.pt", "step_000000002.pt", "step_000000003.pt"]
    assert mgr.latest().endswith("step_000000003.pt")
    assert load_metadata(str(tmp_path / "best.pt")) == {"step": 2,
                                                        "metric": 1.0}
    mgr.save(4, {"x": torch.tensor(4)}, metadata={"preempted": True})
    assert load_metadata(mgr.latest())["preempted"] is True
    again = CheckpointManager(str(tmp_path))
    assert again.best == 1.0
    again.save(5, {"x": torch.tensor(5)}, metric=1.5)
    assert load_metadata(str(tmp_path / "best.pt"))["step"] == 2


def test_metric_logger_and_meters(tmp_path):
    with MetricLogger(str(tmp_path)) as logger:
        logger.log(3, {"loss": torch.tensor(0.5)}, prefix="train/")
        path = logger.log_image("grid", np.zeros((4, 6, 3), np.uint8), 3)
    line = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert line["train/loss"] == 0.5 and line["step"] == 3
    assert path.endswith(os.path.join("grid", "0003.jpg"))
    assert np.asarray(Image.open(path)).shape == (4, 6, 3)
    m = AverageMeter()
    m.update(2.0, n=3)
    assert m.avg == 2.0 and m.count == 3
    assert aggregate_loss_dicts([{"a": 1}, {"a": 3, "b": 2}]) == {"a": 2.0,
                                                                 "b": 2.0}


def test_images_dataset_pairs(tmp_path):
    src = _faces(tmp_path / "src", n=3, size=20)
    ds = ImagesDataset(str(src))
    assert len(ds) == 3
    x, y = ds[1]
    assert x.shape == y.shape == (112, 112, 3) and x.dtype == np.float32
    np.testing.assert_array_equal(x, y)
    assert -1 <= x.min() and x.max() <= 1
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(ds.source_paths[:2]))
    with pytest.raises(ValueError, match="targets"):
        ImagesDataset(str(src), str(lst))


def test_face_grid_layout():
    a = torch.full((8, 8, 3), -1.0)
    b = torch.ones(8, 8, 3)
    grid = face_grid([{"input_face": a, "target_face": b,
                       "output_face": [a, b]},
                      {"input_face": b, "target_face": a,
                       "output_face": b}])
    assert grid.shape == (16, 32, 3) and grid.dtype == np.uint8
    assert grid[0, 0, 0] == 0 and grid[0, 8, 0] == 255
    assert (grid[8:, 24:] == 0).all()       # the short row is padded


def test_preemption_handler_sets_the_event():
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        stop = install_preemption_handler()
        assert not stop.is_set()
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.wait(timeout=5)
    finally:
        for s, h in old.items():
            signal.signal(s, h)
