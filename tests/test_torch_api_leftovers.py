"""The last public JAX symbols in the port, on the CPU.

* ``data/dataset.py::device_augment``: every output image is a
  ``crop``² window of its input, flipped or not, and the offsets and
  flips are the draws of the trainer's former inline pair
  (``random_crop`` then ``random_hflip``) on the same generator, so
  ``Stage3Trainer.train_step`` with ``augment_crop`` is unchanged bit for
  bit. (JAX draws from its keys: no draw can match.)
* ``ops/modconv.py::modulated_conv2d_grouped``, the per-sample-weight
  oracle, against JAX's on the same numpy inputs and against the port's
  ``modulated_conv2d``, f32, within 1e-5 of the output's scale.
* ``utils/export.py::export_jittable``: a plain function closing over a
  model and a module, with a symbolic batch, saved and loaded, equal to
  eager.
* ``utils/config.py::Stage2Options`` / ``Stage2TestOptions``: JAX's
  fields and defaults.
* ``FacesDataset(id2race_file=)``, ``id2race`` and ``classes`` as JAX's.
* ``MetricLogger.log_image``: JAX's ``[<subscript>_]<step:04d>.jpg``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from stylegan_for_facerec_tpu.data.dataset import \
    FacesDataset as JFacesDataset
from stylegan_for_facerec_tpu.ops import modconv as jmodconv
from stylegan_for_facerec_tpu.utils import config as jconfig
from stylegan_for_facerec_tpu.utils.logging import \
    MetricLogger as JMetricLogger
from stylegan_for_facerec_torch.data import device_augment
from stylegan_for_facerec_torch.data.dataset import FacesDataset
from stylegan_for_facerec_torch.ops import (modulated_conv2d,
                                            modulated_conv2d_grouped)
from stylegan_for_facerec_torch.ops.image import random_crop, random_hflip
from stylegan_for_facerec_torch.utils import config
from stylegan_for_facerec_torch.utils import export as ex
from stylegan_for_facerec_torch.utils.logging import MetricLogger
from test_torch_stage3 import port_trainer

MODCONV_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- device_augment -----------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.uint8, torch.float32))
def test_device_augment_gives_windows_of_the_input(dtype):
    n, size, crop = 64, 20, 14
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (n, size, size, 3))).to(dtype)
    g = torch.Generator().manual_seed(2)
    out = device_augment(x, g, crop=crop)
    assert out.shape == (n, crop, crop, 3) and out.dtype == dtype
    offsets, flips = set(), 0
    for i in range(n):
        hits = [(dy, dx, f) for dy in range(size - crop + 1)
                for dx in range(size - crop + 1) for f in (0, 1)
                if torch.equal(out[i], (x[i, dy:dy + crop, dx:dx + crop]
                                        .flip(1) if f else
                                        x[i, dy:dy + crop, dx:dx + crop]))]
        assert len(hits) == 1, (i, hits)
        offsets.add(hits[0][:2])
        flips += hits[0][2]
    assert len(offsets) > 10 and 0 < flips < n

    # the trainer's former inline pair on the same generator state
    g.manual_seed(2)
    want = random_hflip(random_crop(x, crop, g), g)
    assert torch.equal(out, want)


def test_device_augment_flip_share():
    x = torch.zeros(1000, 4, 4, 3, dtype=torch.uint8)
    x[:, :, 0] = 1                   # the left column marks the orientation
    out = device_augment(x, torch.Generator().manual_seed(3), crop=4,
                         hflip_p=0.25)
    share = float((out[:, 0, -1, 0] == 1).float().mean())
    assert abs(share - 0.25) < 0.05


def test_stage3_step_is_the_inline_pair_bit_for_bit():
    big = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (8, 36, 36, 3), dtype=np.uint8))
    y = torch.from_numpy(np.random.RandomState(8).randint(0, 64, 8))
    a = port_trainer(augment_crop=28)
    b = port_trainer(augment_crop=None)
    ma = a.train_step(big, y, 0)
    # the parent's step: crop, then flip, from the trainer's generator
    images = random_crop(big, 28, b.generator)
    images = random_hflip(images, b.generator)
    mb = b.train_step(images, y, 0)
    for k in ("loss", "top1", "top5"):
        assert torch.equal(ma[k], mb[k]), k
    sa, sb = a.state_dict(), b.state_dict()
    for part in ("backbone", "head"):
        for k, v in sa[part].items():
            assert torch.equal(v, sb[part][k]), (part, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# -- modulated_conv2d_grouped -------------------------------------------------

@pytest.mark.parametrize("demodulate", (True, False))
@pytest.mark.parametrize("padding", (0, 1))
def test_grouped_modconv_matches_jax_and_the_scaled_form(demodulate,
                                                         padding):
    rng = np.random.RandomState(4 + padding)
    x = rng.randn(3, 6, 9, 9).astype(np.float32)          # (N, I, H, W)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)          # (O, I, kh, kw)
    s = rng.uniform(0.2, 2.0, (3, 6)).astype(np.float32)
    got = modulated_conv2d_grouped(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(s), padding=padding,
                                   demodulate=demodulate).numpy()
    want = np.asarray(jmodconv.modulated_conv2d_grouped(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(w.transpose(2, 3, 1, 0)), jnp.asarray(s),
        padding=padding, demodulate=demodulate)).transpose(0, 3, 1, 2)
    scaled = modulated_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(s), padding=padding,
                              demodulate=demodulate).numpy()
    assert got.shape == want.shape == scaled.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= MODCONV_REL * scale
    assert np.abs(got - scaled).max() <= MODCONV_REL * scale


# -- export_jittable ----------------------------------------------------------

def test_export_jittable_round_trip(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.LeakyReLU(0.2),
                              torch.nn.Linear(8, 3)).eval()
    bias = torch.randn(3, generator=torch.Generator().manual_seed(5))

    def fn(x, y):
        return net(x) * 2.0 + y.sum(dim=1, keepdim=True) + bias

    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(6))
    y = torch.randn(4, 2, generator=torch.Generator().manual_seed(7))
    batch = torch.export.Dim("batch", min=1, max=64)
    exported = ex.export_jittable(fn, (x, y), ({0: batch}, {0: batch}))
    ex.save_exported(exported, str(tmp_path / "fn"))
    loaded = ex.load_exported(str(tmp_path / "fn")).module()
    for n in (1, 4, 9):
        xn, yn = torch.randn(n, 6), torch.randn(n, 2)
        with torch.no_grad():
            assert torch.equal(loaded(xn, yn), fn(xn, yn))
    pinned = ex.export_jittable(net, (x,))         # a module, shapes pinned
    with torch.no_grad():
        assert torch.equal(pinned.module()(x), net(x))


# -- the records, the dataset and the logger ---------------------------------

@pytest.mark.parametrize("name", ("Stage2Options", "Stage2TestOptions"))
def test_stage2_records_match_jax(name):
    got, want = getattr(config, name), getattr(jconfig, name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())


def test_faces_dataset_id2race_matches_jax(tmp_path):
    for ident in ("African^m.01", "Asian^m.02"):
        (tmp_path / "faces" / ident).mkdir(parents=True)
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
            tmp_path / "faces" / ident / "0.jpg")
    races = tmp_path / "id2race.txt"
    races.write_text("m.01 African\nm.02 Asian")
    got = FacesDataset(str(tmp_path / "faces"), 16, str(races))
    want = JFacesDataset(str(tmp_path / "faces"), 16, str(races))
    assert got.id2race == want.id2race == {"m.01": "African",
                                           "m.02": "Asian"}
    assert got.classes == want.classes == ["m.01", "m.02"]
    assert FacesDataset(str(tmp_path / "faces")).id2race is None


def test_log_image_names_match_jax(tmp_path):
    img = np.random.RandomState(9).randint(0, 256, (6, 10, 3), np.uint8)
    with MetricLogger(str(tmp_path / "port")) as logger:
        paths = [logger.log_image("grid", img, 7),
                 logger.log_image("grid", Image.fromarray(img), 12,
                                  subscript="val")]
    jlog = JMetricLogger(str(tmp_path / "jax"))
    want = [jlog.log_image("grid", img, 7),
            jlog.log_image("grid", img, 12, subscript="val")]
    assert [os.path.relpath(p, tmp_path / "port") for p in paths] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want] == \
        [os.path.join("grid", "0007.jpg"),
         os.path.join("grid", "val_0012.jpg")]
    for p in paths:
        assert np.asarray(Image.open(p)).shape == (6, 10, 3)
    assert MetricLogger().log_image("grid", img, 1) is None
