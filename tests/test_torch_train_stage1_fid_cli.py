"""The port's stage-1 CLI with ``--fid_inception`` on the CPU: two steps
over eight PNGs at 32 px with FID every step from a torchvision-schema
InceptionV3 file (seeded weights and BatchNorm statistics, with the
``fc.``/``AuxLogits.`` heads that the loader drops). The FID function
itself is held against ``embedding_fid`` over InceptionV3 features
(resized to 299) of the same reals and g_ema samples, to 1e-6
relative (the same float64 statistics of the same f32 features)."""

import argparse
import re
import types

import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_torch.data.images_dataset import InferenceDataset
from stylegan_for_facerec_torch.eval.fid import embedding_fid
from stylegan_for_facerec_torch.models import InceptionV3
from stylegan_for_facerec_torch.models.stylegan2_ada import Generator
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.tools import train_stage1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_inception(seed: int = 0) -> InceptionV3:
    net = init_weights(InceptionV3(), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                m.running_var.copy_(0.5 + torch.rand(c, generator=g))
    return net.eval()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid_cli")
    data = root / "faces"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(8):
        Image.fromarray(rng.randint(0, 255, (32, 32, 3), np.uint8)).save(
            data / f"img{i}.png")
    sd = dict(seeded_inception().state_dict())
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), \
        torch.zeros(1000)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    path = root / "pt_inception.pth"
    torch.save(sd, path)
    return root, data, path


def test_cli_reports_inception_fid(files, capsys):
    root, data, path = files
    train_stage1.main(["--data_root", str(data), "--exp_dir",
                       str(root / "run"), "--image_size", "32",
                       "--batch_size", "4", "--max_steps", "2",
                       "--fid_interval", "1", "--fid_n", "4",
                       "--fid_inception", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"[fid] InceptionV3 pool3 features ({path})" in out
    (fid,) = re.findall(r"step 1 fid512 ([0-9.]+)", out)
    assert np.isfinite(float(fid)) and float(fid) > 0


def test_fid_fn_is_inception_embedding_fid(files):
    """``compute_fid(step)``: fid_n reals in the order of
    ``default_rng(step)`` and fid_n g_ema samples from a generator seeded
    with ``step``, through InceptionV3 resized to 299."""
    root, data, path = files
    g_ema = init_weights(Generator(64, 64, 2, 32),
                         torch.Generator().manual_seed(3)).eval()
    trainer = types.SimpleNamespace(cfg=types.SimpleNamespace(z_dim=64),
                                    g_ema=g_ema)
    ds = InferenceDataset(str(data), size=32)
    args = argparse.Namespace(fid_n=4, fid_inception=str(path),
                              fid_encoder=None)
    got = train_stage1._fid_fn(args, trainer, ds, torch.device("cpu"))(5)
    reals = np.stack([ds[j] for j in np.random.default_rng(5).permutation(
        len(ds))[:4]])
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        z = torch.randn((4, 64), generator=gen)
        fakes = g_ema(z, generator=gen).permute(0, 2, 3, 1)
    net = seeded_inception()

    @torch.no_grad()
    def embed(images):
        return net(torch.as_tensor(images).permute(0, 3, 1, 2).float())

    assert got == pytest.approx(embedding_fid(embed, reals, fakes, 4),
                                rel=1e-6)
