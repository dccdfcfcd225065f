"""Package-level checks of the PyTorch port on the CPU: import isolation
from JAX, the GPU-by-default entry points, checkpoints and the inversion
CLI."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from stylegan_for_facerec_torch.eval.inference import run_on_batch, tensor2im
from stylegan_for_facerec_torch.models.irse import IR_50
from stylegan_for_facerec_torch.models.psp import PSp, build_psp
from stylegan_for_facerec_torch.tools import inference_iterative
from stylegan_for_facerec_torch.train.stage3 import Stage3Config, Stage3Trainer
from stylegan_for_facerec_torch.utils.checkpoint import (load_checkpoint,
                                                         save_checkpoint)
from stylegan_for_facerec_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# the stage-3, e4e and InceptionV3 / loss-evaluation modules, which the
# walk below must reach
STAGE3_MODULES = (
    "data.dataset", "data.packed", "eval.verification",
    "eval.verify_runner", "losses.focal", "models.heads", "train.stage3",
    "tools.test_rfw", "tools.train_stage3", "utils.config",
    "models.e4e", "models.resnet", "train.stage2_e4e",
    "tools.train_stage2_e4e", "models.inception",
    "tools.calc_losses_on_images",
    # the host data path and face preprocessing, which import no cv2
    "data.registry", "data.randaugment", "data.native_loader",
    "models.mtcnn", "tools.make_filelist", "tools.pack_train",
    "tools.pack_rfw", "tools.mtcnn_crop_align", "tools.rfw_crop_align")


def test_port_imports_no_jax():
    """Every port module, and chip_smoke.py, import with jax blocked and
    load nothing of the JAX package; the walk covers the stage-3, e4e,
    InceptionV3, loss-evaluation, host data and MTCNN modules, and none of
    them imports cv2."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["cv2"] = None
        import stylegan_for_facerec_torch as pkg
        walked = set()
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
            walked.add(m.name)
        import chip_smoke
        bad = [m for m in sys.modules
               if m.startswith(("stylegan_for_facerec_tpu", "jax", "cv2"))
               and sys.modules[m] is not None]
        assert not bad, bad
        missing = [m for m in %r
                   if "stylegan_for_facerec_torch." + m not in walked]
        assert not missing, missing
        print("OK", len([m for m in sys.modules
                         if m.startswith("stylegan_for_facerec_torch")]))
    """ % (STAGE3_MODULES,))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_psp(output_size=32, input_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Stage3Trainer(IR_50(32), Stage3Config(num_classes=4))
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_psp_is_seeded():
    a = build_psp(output_size=32, input_size=32, seed=3, device="cpu",
                  n_latent=64)
    b = build_psp(output_size=32, input_size=32, seed=3, device="cpu",
                  n_latent=64)
    assert not a.training
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.equal(a.latent_avg, b.latent_avg)
    assert a.latent_avg.abs().sum() > 0
    w = a.encoder.body[0].res_layer[1].weight
    assert 0.5 < w.std() / (2.0 / (w[0].numel() + w.shape[0] * 9)) ** 0.5 < 2


def test_output_size_128_pools_to_256():
    """The CLI's default configuration: 128 px synthesis, face_pool
    upsampling to 256, 14 styles."""
    model = build_psp(output_size=128, input_size=112, device="cpu",
                      n_latent=16)
    assert model.n_styles == 14 and model.decoder.num_ws == 14
    x = torch.rand(1, 112, 112, 3) * 2 - 1
    outs, lats = run_on_batch(model, x, torch.zeros(112, 112, 3), 1)
    assert outs.shape == (1, 1, 256, 256, 3) and lats.shape == (1, 1, 14, 512)
    assert torch.isfinite(outs).all()
    # adaptive average pooling 128 -> 256 duplicates each pixel
    img = outs[0, 0]
    assert torch.equal(img[0::2, 0::2], img[1::2, 1::2])


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    model = build_psp(output_size=32, input_size=112, seed=1, device="cpu",
                      n_latent=64)
    avg = torch.rand(112, 112, 3) * 2 - 1
    path = str(d / "psp.pt")
    save_checkpoint(path, model, avg)
    return path, model, avg


def test_checkpoint_round_trip(saved_model):
    path, model, avg = saved_model
    fresh = PSp(output_size=32, input_size=112)
    got_avg = load_checkpoint(path, fresh)
    assert torch.equal(got_avg, avg)
    assert torch.equal(fresh.latent_avg, model.latent_avg)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_inference_cli_cpu_smoke(saved_model, tmp_path):
    from PIL import Image
    path, model, avg = saved_model
    data = tmp_path / "faces"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(
            data / f"img{i}.png")
    out = tmp_path / "out"
    inference_iterative.main([
        "--checkpoint_path", path, "--data_path", str(data),
        "--exp_dir", str(out), "--n_iters_per_batch", "2",
        "--test_batch_size", "2", "--output_size", "32", "--save_latents",
        "--device", "cpu"])
    for i in range(3):
        img = np.asarray(Image.open(out / "inference_results" / f"img{i}.jpg"))
        assert img.shape == (256, 256, 3)
    lats = np.load(out / "latents.npy", allow_pickle=True).item()
    assert sorted(lats) == ["img0", "img1", "img2"]
    assert lats["img0"].shape == (2, 10, 512)
    assert np.isfinite(lats["img2"]).all()


def test_inference_cli_default_device_raises_without_gpu(saved_model,
                                                         tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference_iterative.main([
            "--checkpoint_path", saved_model[0], "--data_path",
            str(tmp_path), "--exp_dir", str(tmp_path / "out")])


def test_run_on_batch_refuses_train_mode():
    model = PSp(output_size=32, input_size=32)
    with pytest.raises(ValueError, match="eval mode"):
        run_on_batch(model, torch.zeros(1, 32, 32, 3),
                     torch.zeros(32, 32, 3), 1)


def test_tensor2im():
    x = torch.tensor([[[-1.0, 0.0, 1.0]]]).expand(2, 2, 3)
    arr = tensor2im(x)
    assert arr.dtype == np.uint8 and arr.shape == (2, 2, 3)
    np.testing.assert_array_equal(arr[0, 0], [0, 127, 255])
