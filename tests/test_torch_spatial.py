"""The port's spatially sharded synthesis (``parallel/spatial.py``) on the
CPU in f32: each rank of a mesh axis computes a band of the image's rows.

The bands run in gloo worker processes (``parallel._mp_worker.spawn``
through ``torch_mp_shared``, once a session): four ranks, with the
spatial axis over all four (data 4) and over two (data 2, model 2: two
independent pairs). The runs are ``_mp_worker.SPATIAL_RUNS["micro"]``:
the ADA G (z/w 32, 2 mapping layers, 64 px, as
``tests/test_multidevice_inference.py:71-99``) with const and random
noise, its StyleGAN1 layer family, and the rosinality G at 64 px
(channel multiplier 1) with and without random noise; two runs keep 4x4
and 8x8 replicated (``min_rows_per_shard`` 4).

Tolerances, with their reasons:
  * const noise against the JAX package's single-device ``apply`` on the
    same weights (the port's seeded model carried across by the JAX
    package's ``from_torch``):
    2e-4 absolute and relative, the JAX test's tolerance (convolutions
    summed in other orders than XLA's);
  * every run against the port's own one-process forward for the same
    seed (random noise drawn whole on every rank from one seed): 1e-5 of
    the image's largest magnitude, f32 round-off of convolutions run on
    other row ranges.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import stylegan2 as jsg2
from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.parallel import _mp_worker as mp
from stylegan_for_facerec_torch.parallel.mesh import Axis
from stylegan_for_facerec_torch.parallel.spatial import (
    make_spatial_synthesis, spatial_shard_fn)
from torch_mp_shared import shared_result, shared_spawn

MESHES = {"spatial:4x1": (4, 1), "spatial:2x2": (2, 2)}
RUNS = {r[0]: r for r in mp.SPATIAL_RUNS["micro"]}
CONST_VS_JAX = ("ada_f32_const", "ada_f32_const_min4", "sg1_f32_const",
                "rosi_f32_const", "rosi_f32_const_min4")
# a min4 run's image is its min1 run's: the same weights, inputs and noise
SAME_IMAGE = {"ada_f32_const_min4": "ada_f32_const",
              "rosi_f32_const_min4": "rosi_f32_const"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return shared_spawn(tmp_path_factory, "spatial", list(MESHES), 4)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    return shared_result(tmp_path_factory, "spatial_one_process",
                         lambda: mp.run_task("spatial", None, device="cpu"))


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    """JAX's image of each const-noise run, once a session."""
    def compute():
        out = {name: jax_image(name) for name in CONST_VS_JAX
               if name not in SAME_IMAGE}
        out.update({k: out[v] for k, v in SAME_IMAGE.items()})
        return out

    return shared_result(tmp_path_factory, "spatial_jax", compute)


def assembled(ranks, spec, name):
    """The image of each spatial group of ``spec``'s mesh: its ranks'
    bands in row order."""
    data, model = MESHES[spec]
    images = []
    for m in range(model):
        bands = sorted((ranks[d * model + m][spec][name]["rows"],
                        ranks[d * model + m][spec][name]["image"])
                       for d in range(data))
        assert [lo for (lo, _), _ in bands] == sorted(
            {lo for (lo, _), _ in bands})
        images.append(torch.cat([b for _, b in bands], dim=2))
    return images


def jax_image(name):
    """JAX's single-device image of run ``name`` on the port's weights."""
    _, family, res, batch, _, noise, _ = RUNS[name]
    sd = {k: v.numpy() for k, v in
          mp.spatial_model(family, res, "micro").state_dict().items()}
    z = jnp.asarray(mp.spatial_inputs(batch, "micro"))
    ctx = Ctx(train=False)
    if family == "rosinality":
        jg = jsg2.Generator(size=res, style_dim=32, n_mlp=2,
                            channel_multiplier=1)
        img, _ = jg.apply(*from_torch(jg, sd), z, ctx,
                          randomize_noise=False)
    else:
        jg = jada.Generator(z_dim=32, w_dim=32, w_num_layers=2,
                            img_resolution=res, synthesis_layer="stylegan1"
                            if family == "stylegan1" else "stylegan2")
        img, _ = jg.apply(*from_torch(jg, sd), z, ctx, noise_mode=noise)
    return np.moveaxis(np.asarray(img), -1, 1)


@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("name", CONST_VS_JAX)
def test_const_noise_matches_jax(ranks, jax_images, spec, name):
    want = jax_images[name]
    for got in assembled(ranks, spec, name):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("spec", list(MESHES))
@pytest.mark.parametrize("name", list(RUNS))
def test_bands_equal_one_process(ranks, one_process, spec, name):
    """Every run, random noise included, against the port's one-process
    forward from the same seed."""
    want = one_process[name]["image"]
    scale = float(want.abs().max())
    for got in assembled(ranks, spec, name):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * scale, (err, scale)


@pytest.mark.parametrize("spec", list(MESHES))
def test_bands_at_every_sharded_resolution(ranks, spec):
    """Each block's output was computed on the rank's band at every
    resolution the JAX rule shards (height divisible by the axis size,
    at least ``min_rows_per_shard`` rows a rank), and whole elsewhere;
    the gathered image holds the rank's band."""
    data, model = MESHES[spec]
    for rank, res in enumerate(ranks):
        index = rank // model
        for name, run in RUNS.items():
            min_rows = run[6]
            want = []
            for r in (4, 8, 16, 32, 64):
                if r % data == 0 and r // data >= min_rows:
                    want.append([r, index * r // data, r // data])
                else:
                    want.append([r, 0, r])
            assert [list(b) for b in res[spec][name]["bands"]] == want, \
                (rank, name)
            assert res[spec][name]["gather_ok"], (rank, name)


def test_policy_guards_small_heights():
    """The JAX test's guard cases (8 devices, min 2 rows a shard): 8 rows
    give 1 a rank and 4 do not divide 8, so both pass through; 16 rows
    are cut to the rank's 2."""
    mesh = types.SimpleNamespace(data=Axis(None, list(range(8)), 3))
    fn = spatial_shard_fn(mesh, "data", min_rows_per_shard=2)
    small = torch.zeros(1, 4, 8, 8)
    tiny = torch.zeros(1, 4, 4, 4)
    ok = torch.arange(16 * 16.0).reshape(1, 1, 16, 16).repeat(1, 4, 1, 1)
    assert fn(small) is small
    assert fn(tiny) is tiny
    vec = torch.zeros(16)
    assert fn(vec) is vec
    assert torch.equal(fn(ok), ok[:, :, 6:8])
    assert fn.rows(16) == (6, 8) and fn.rows(8) == (0, 8)


def test_synthesis_refuses_an_unsharded_output():
    mesh = types.SimpleNamespace(data=Axis(None, [0, 1, 2], 0))
    g = mp.spatial_model("ada", 64, "micro")
    with pytest.raises(ValueError, match="not sharded"):
        make_spatial_synthesis(g, mesh, noise_mode="const")
    with pytest.raises(TypeError, match="Generator"):
        make_spatial_synthesis(torch.nn.Linear(2, 2), mesh)
