"""The port's stage-1 training CLI on the CPU: three steps over eight PNGs
at 32 px, a checkpoint with the full trainer state, ``--resume`` carrying
the step count on, and the stage-1 -> stage-2 handoff: ``train_stage2
--stylegan_weights <stage-1 run dir>`` starts its decoder from the run's
g_ema, and a directory without g_ema, or of another image size, is
refused."""

import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.models.stylegan2_ada import Generator
from stylegan_for_facerec_torch.tools import train_stage1, train_stage2
from stylegan_for_facerec_torch.utils.checkpoint import (
    CheckpointManager, load_generator_handoff, load_metadata)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _faces(d, n=8, size=32):
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            d / f"img{i}.png")
    return d


def _args(data, exp, *extra):
    return ["--data_root", str(data), "--exp_dir", str(exp), "--image_size",
            "32", "--batch_size", "4", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def stage1_run(tmp_path_factory):
    """Three steps, then a resumed run to step 4: (data dir, run dir,
    printed output of the resumed run)."""
    root = tmp_path_factory.mktemp("stage1")
    data, exp = _faces(root / "faces"), root / "run"
    train_stage1.main(_args(data, exp, "--max_steps", "3"))
    first = sorted(p.name for p in exp.glob("step_*.pt"))
    saved = torch.load(exp / "step_000000002.pt", map_location="cpu",
                       weights_only=True)
    yield data, exp, first, saved
    shutil.rmtree(root, ignore_errors=True)


def test_cli_three_steps_writes_the_full_state(stage1_run):
    _, exp, first, saved = stage1_run
    assert first == ["step_000000002.pt"]
    assert load_metadata(str(exp / "step_000000002.pt"))["step"] == 2
    for k in ("g", "d", "g_ema", "opt_g", "opt_d", "ada_p", "rt_accum",
              "rt_count", "pl_mean", "step"):
        assert k in saved, k
    assert saved["step"] == 3
    assert saved["opt_g"]["state"][0]["step"] == 3
    assert saved["opt_d"]["state"][0]["step"] == 3
    assert float(saved["pl_mean"]) != 0.0
    assert "mapping.w_avg" in saved["g_ema"]
    assert torch.equal(saved["g_ema"]["mapping.w_avg"],
                       saved["g"]["mapping.w_avg"])
    for v in saved["g"].values():
        assert torch.isfinite(v).all()


def test_cli_resume_continues_the_step_count(stage1_run, capsys):
    data, exp, _, saved = stage1_run
    capsys.readouterr()
    train_stage1.main(_args(data, exp, "--max_steps", "4", "--resume"))
    out = capsys.readouterr().out
    assert "[resume] from" in out and "step 3" in out
    last = torch.load(exp / "step_000000003.pt", map_location="cpu",
                      weights_only=True)
    assert last["step"] == 4
    assert last["opt_g"]["state"][0]["step"] == 4
    assert not torch.equal(last["g"]["mapping.layers.0.weight"],
                           saved["g"]["mapping.layers.0.weight"])


def test_stage2_cli_starts_from_the_stage1_g_ema(stage1_run, tmp_path,
                                                 capsys):
    data, exp, _, _ = stage1_run
    want = torch.load(CheckpointManager(str(exp)).latest(),
                      map_location="cpu", weights_only=True)["g_ema"]
    s2 = tmp_path / "s2"
    try:
        train_stage2.main(["--source_root", str(data), "--exp_dir", str(s2),
                           "--output_size", "32", "--batch_size", "2",
                           "--max_steps", "1", "--lpips_lambda", "0",
                           "--device", "cpu", "--stylegan_weights",
                           str(exp)])
        assert "loaded generator weights (stage-1 run dir)" in \
            capsys.readouterr().out
        ckpt = torch.load(s2 / "step_000000000.pt", map_location="cpu",
                          weights_only=True)
        dec = {k[len("decoder."):]: v for k, v in ckpt["state_dict"].items()
               if k.startswith("decoder.")}
        assert set(dec) == set(want)
        for k in want:                  # the decoder is frozen in stage 2
            assert torch.equal(dec[k], want[k]), k
    finally:
        shutil.rmtree(s2, ignore_errors=True)


def test_handoff_refuses_wrong_directories(stage1_run, tmp_path):
    _, exp, _, _ = stage1_run
    with pytest.raises(SystemExit, match="image size"):
        load_generator_handoff(str(exp), Generator(img_resolution=64))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no step_"):
        load_generator_handoff(str(empty), Generator(img_resolution=32))
    other = tmp_path / "other"
    CheckpointManager(str(other)).save(0, {"state_dict": {}})
    with pytest.raises(SystemExit, match="g_ema"):
        load_generator_handoff(str(other), Generator(img_resolution=32))
    dec = Generator(img_resolution=32)
    assert load_generator_handoff(str(exp), dec) == "stage-1 run dir"
