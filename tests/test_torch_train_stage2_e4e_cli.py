"""The port's e4e training CLI on the CPU: three steps over four PNGs at
output 32 with ``--progressive_steps 0 1`` (stage 0, then stage 1), a
validation pass with the adversarial term, the decoder from a port
stage-1 run directory (``--stylegan_weights``), a checkpoint with D and
both optimizers, ``--resume`` restoring them with the step and
``avg_image.npy``; then ``inference_iterative --model_2_checkpoint_path``
bootstrapping a PSp from the e4e checkpoint.

An e4e checkpoint holds the IR-SE-50 encoder with 10 style heads and its
Ranger state (~1.8 GB); each run directory is removed as soon as the
module's tests end."""

import contextlib
import io
import json
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.models.psp import PSp, build_psp
from stylegan_for_facerec_torch.tools import (inference_iterative,
                                              train_stage1, train_stage2_e4e)
from stylegan_for_facerec_torch.utils.checkpoint import (
    CheckpointManager, load_checkpoint, load_metadata, save_checkpoint)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _faces(d, n=4, size=32):
    d.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (size, size, 3), np.uint8)).save(
            d / f"img{i}.png")
    return d


def _args(data, exp, *extra):
    return ["--source_root", str(data), "--exp_dir", str(exp),
            "--output_size", "32", "--batch_size", "2", "--image_interval",
            "0", "--device", "cpu", "--allow_random_lpips",
            "--progressive_steps", "0", "1", *extra]


@pytest.fixture(scope="module")
def e4e_run(tmp_path_factory):
    """A one-step stage-1 run at 32 px, then three e4e steps from its
    g_ema with validation at step 2: (root, data, stage-1 dir, e4e dir,
    printed output, step-2 checkpoint)."""
    root = tmp_path_factory.mktemp("e4e")
    data = _faces(root / "faces")
    s1 = root / "stage1"
    train_stage1.main(["--data_root", str(data), "--exp_dir", str(s1),
                       "--image_size", "32", "--batch_size", "2",
                       "--max_steps", "1", "--device", "cpu"])
    exp = root / "e4e"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_stage2_e4e.main(_args(data, exp, "--max_steps", "3",
                                    "--stylegan_weights", str(s1),
                                    "--val_root", str(data),
                                    "--val_interval", "2"))
    saved = torch.load(exp / "step_000000002.pt", map_location="cpu",
                       weights_only=True)
    yield root, data, s1, exp, out.getvalue(), saved
    shutil.rmtree(root, ignore_errors=True)


def test_three_steps_with_stage_switch_and_validation(e4e_run):
    _, _, _, exp, printed, saved = e4e_run
    assert "[progressive] stage -> 0" in printed
    assert "[progressive] stage -> 1" in printed
    assert sorted(p.name for p in exp.glob("step_*.pt")) == [
        "step_000000002.pt"]
    assert load_metadata(str(exp / "step_000000002.pt"))["step"] == 2
    for k in ("state_dict", "latent_avg", "avg_image", "optimizer",
              "discriminator", "d_optimizer"):
        assert k in saved, k
    assert saved["optimizer"]["state"][0]["step"] == 3
    assert int(saved["d_optimizer"]["state"][0]["step"]) == 3
    assert sorted(saved["discriminator"]) == [
        f"mlp.{i}.{p}" for i in (0, 2, 4, 6) for p in ("bias", "weight")]
    logs = [json.loads(line) for line in
            (exp / "logs" / "metrics.jsonl").read_text().splitlines()]
    train0 = logs[0]
    assert train0["step"] == 0
    for k in ("loss", "loss_l2", "loss_lpips", "encoder_discriminator_loss",
              "total_delta_loss", "d_loss"):
        assert np.isfinite(train0[f"train/{k}"]), k
    assert train0["train/total_delta_loss"] == 0.0       # stage 0
    val = [entry for entry in logs if "val/loss" in entry]
    assert [entry["step"] for entry in val] == [2]
    assert np.isfinite(val[0]["val/encoder_discriminator_loss"])


def test_decoder_comes_from_the_stage1_run(e4e_run):
    _, _, s1, _, printed, saved = e4e_run
    assert "loaded generator weights (stage-1 run dir)" in printed
    want = torch.load(CheckpointManager(str(s1)).latest(),
                      map_location="cpu", weights_only=True)["g_ema"]
    dec = {k[len("decoder."):]: v for k, v in saved["state_dict"].items()
           if k.startswith("decoder.")}
    assert set(dec) == set(want)
    for k in want:                      # the decoder is frozen in stage 2
        assert torch.equal(dec[k], want[k]), k


def test_resume_restores_d_optimizers_step_and_avg_image(e4e_run, capsys):
    _, data, _, exp, _, saved = e4e_run
    avg = np.load(exp / "avg_image.npy")
    capsys.readouterr()
    train_stage2_e4e.main(_args(data, exp, "--max_steps", "4", "--resume"))
    printed = capsys.readouterr().out
    assert "[resume] from" in printed and "step 3" in printed
    assert "[progressive] stage -> 1" in printed
    last = torch.load(exp / "step_000000003.pt", map_location="cpu",
                      weights_only=True)
    assert last["optimizer"]["state"][0]["step"] == 4
    assert int(last["d_optimizer"]["state"][0]["step"]) == 4
    np.testing.assert_array_equal(np.load(exp / "avg_image.npy"), avg)
    np.testing.assert_array_equal(last["avg_image"].numpy(), avg)
    assert torch.equal(last["latent_avg"], saved["latent_avg"])
    w = "mlp.0.weight"
    assert not torch.equal(last["discriminator"][w],
                           saved["discriminator"][w])
    enc = "encoder.input_layer.0.weight"
    assert not torch.equal(last["state_dict"][enc], saved["state_dict"][enc])


def test_inference_bootstraps_from_the_e4e_checkpoint(e4e_run):
    """The e4e checkpoint loads as a PSp; with a second (PSp) checkpoint
    the first iteration is model 1's alone and the later ones model 2's."""
    root, data, _, exp, _, _ = e4e_run
    ckpt = str(exp / "step_000000002.pt")
    load_checkpoint(ckpt, PSp(output_size=32))      # loads strictly
    psp2 = str(root / "psp2.pt")
    save_checkpoint(psp2, build_psp(output_size=32, seed=5, device="cpu",
                                    n_latent=64))
    lat = {}
    for name, extra in (("single", []),
                        ("boot", ["--model_2_checkpoint_path", psp2])):
        out = root / name
        inference_iterative.main(
            ["--checkpoint_path", ckpt, "--data_path", str(data),
             "--exp_dir", str(out), "--output_size", "32",
             "--n_iters_per_batch", "3", "--test_batch_size", "4",
             "--save_latents", "--device", "cpu", *extra])
        assert len(list((out / "inference_results").glob("*.jpg"))) == 4
        lat[name] = np.load(out / "latents.npy", allow_pickle=True).item()
    for k, single in lat["single"].items():
        boot = lat["boot"][k]
        assert single.shape == boot.shape == (3, 10, 512)
        assert np.isfinite(boot).all()
        np.testing.assert_array_equal(boot[0], single[0])
        assert not np.allclose(boot[1:], single[1:])


def test_cli_refuses_random_lpips_and_missing_gpu(tmp_path):
    data = _faces(tmp_path / "faces", n=2)
    args = _args(data, tmp_path / "run", "--max_steps", "1")
    args.remove("--allow_random_lpips")
    with pytest.raises(SystemExit, match="lpips_weights"):
        train_stage2_e4e.main(args)
    if not torch.cuda.is_available():
        i = args.index("--device")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_stage2_e4e.main(args[:i] + args[i + 2:])
