"""The port's modules and inversion path against the JAX package, on the CPU.

Each test builds the JAX module, gives its BatchNorm running statistics,
biases and noise strengths seeded non-trivial values, carries the weights
across with ``from_jax``, and runs both on the same numpy inputs in f32.
Tolerances are stated per test: single blocks agree to ~1e-5; the deep
IR-SE encoder sums its convolutions in another order than XLA, so the
whole path is held to 1e-4 relative to the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.eval import inference as jinf
from stylegan_for_facerec_tpu.models import irse as jirse
from stylegan_for_facerec_tpu.models import psp as jpsp
from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.eval.inference import run_on_batch
from stylegan_for_facerec_torch.models import irse, psp, stylegan2_ada
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax

CTX = Ctx(train=False)


def perturbed(layer, seed):
    """JAX (params, state) as numpy with non-trivial BN statistics, biases
    and noise strengths."""
    params, state = layer.init(jax.random.key(seed))
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.array(v)
            if k in ("bias", "noise_strength", "mean"):
                v = v + 0.1 * rng.randn(*v.shape).astype(np.float32)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            out[k] = v
        return out

    return walk(params), walk(state)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def assert_close_scaled(got, want, rel):
    """|got - want| <= rel * max|want|, elementwise."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("in_c,depth,stride", [(16, 32, 2), (32, 32, 1)])
def test_bottleneck_ir_se(in_c, depth, stride):
    jm = jirse.BottleneckIR(in_c, depth, stride, se=True)
    params, state = perturbed(jm, 0)
    x = np.random.RandomState(1).randn(2, 8, 8, in_c).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), CTX)
    tm = irse.BottleneckIR(in_c, depth, stride, se=True).eval()
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_backbone_encoder_34():
    jm = jpsp.BackboneEncoder(34, "ir_se", n_styles=3, input_nc=6,
                              style_spatial=2)
    params, state = perturbed(jm, 2)
    x = np.random.RandomState(3).randn(2, 32, 32, 6).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), CTX)
    tm = psp.BackboneEncoder(34, "ir_se", n_styles=3, input_nc=6,
                             style_spatial=2).eval()
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = tm(nchw(x)).numpy()
    assert got.shape == (2, 3, 512)
    assert_close_scaled(got, np.asarray(want), 1e-4)


def test_gradual_style_block_rejects_non_1x1():
    block = psp.GradualStyleBlock(8, 8, spatial=2)
    with pytest.raises(ValueError, match="not 1x1"):
        block(torch.zeros(1, 8, 4, 4))


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_synthesis_layer_up(noise_mode):
    jm = jada.SynthesisLayer(16, 8, w_dim=32, resolution=16, up=True)
    params, state = perturbed(jm, 4)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = rng.randn(2, 32).astype(np.float32)
    want, _ = jm.apply(params, state, (jnp.asarray(x), jnp.asarray(w)), CTX,
                       noise_mode=noise_mode)
    tm = stylegan2_ada.SynthesisLayer(16, 8, w_dim=32, resolution=16,
                                      up=True)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = nhwc(tm(nchw(x), torch.from_numpy(w), noise_mode=noise_mode))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_synthesis_layer_random_noise_needs_a_generator():
    tm = stylegan2_ada.SynthesisLayer(4, 4, w_dim=8, resolution=4)
    with pytest.raises(ValueError, match="Generator"):
        tm(torch.zeros(1, 4, 4, 4), torch.zeros(1, 8), noise_mode="random")
    y = tm(torch.zeros(1, 4, 4, 4), torch.zeros(1, 8), noise_mode="random",
           generator=torch.Generator().manual_seed(0))
    assert y.shape == (1, 4, 4, 4)


def test_generator_const_noise():
    jm = jada.Generator(z_dim=32, w_dim=32, w_num_layers=2,
                        img_resolution=32, img_channels=3)
    params, state = perturbed(jm, 6)
    z = np.random.RandomState(7).randn(2, 32).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(z), CTX,
                       noise_mode="const")
    tm = stylegan2_ada.Generator(z_dim=32, w_dim=32, w_num_layers=2,
                                 img_resolution=32, img_channels=3)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    with torch.no_grad():
        got = nhwc(tm(torch.from_numpy(z), noise_mode="const"))
    assert got.shape == (2, 32, 32, 3)
    assert_close_scaled(got, np.asarray(want), 1e-5)


@pytest.fixture(scope="module")
def psp_pair():
    """JAX PSp(32, 32) and the port's, with the same weights."""
    jm = jpsp.PSp(output_size=32, input_size=32)
    params, state = perturbed(jm, 8)
    state["latent_avg"] = (0.1 * np.random.RandomState(9).randn(
        jm.n_styles, 512)).astype(np.float32)
    tm = load_from_jax(psp.PSp(output_size=32, input_size=32), params,
                       state).eval()
    return jm, params, state, tm


def test_from_jax_equals_to_torch(psp_pair):
    jm, params, state, tm = psp_pair
    want = to_torch(jm, params, state)
    got = from_jax(tm, params, state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        assert got[k].dtype == torch.from_numpy(np.asarray(v)).dtype, k
    tm.load_state_dict(got, strict=True)
    np.testing.assert_array_equal(tm.latent_avg.numpy(), state["latent_avg"])
    assert "latent_avg" not in tm.state_dict()


def test_psp_forward(psp_pair):
    jm, params, state, tm = psp_pair
    rng = np.random.RandomState(10)
    x = rng.randn(2, 32, 32, 6).astype(np.float32)
    latent = (0.1 * rng.randn(2, jm.n_styles, 512)).astype(np.float32)
    for lat in (None, latent):
        (want_img, want_codes), _ = jm.apply(
            params, state, (jnp.asarray(x), None if lat is None
                            else jnp.asarray(lat)), CTX,
            randomize_noise=False, return_latents=True)
        with torch.no_grad():
            img, codes = tm(nchw(x), None if lat is None
                            else torch.from_numpy(lat),
                            randomize_noise=False, return_latents=True)
        assert img.shape == (2, 3, 256, 256)
        assert_close_scaled(codes.numpy(), np.asarray(want_codes), 1e-4)
        assert_close_scaled(nhwc(img), np.asarray(want_img), 1e-4)


def test_run_on_batch_two_iterations(psp_pair):
    jm, params, state, tm = psp_pair
    rng = np.random.RandomState(11)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    avg = rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32)
    want_o, want_l = jinf.run_on_batch(jm, params, state, jnp.asarray(x),
                                       jnp.asarray(avg), n_iters=2)
    outs, lats = run_on_batch(tm, torch.from_numpy(x), torch.from_numpy(avg),
                              n_iters=2)
    assert outs.shape == (2, 2, 256, 256, 3)
    assert lats.shape == (2, 2, jm.n_styles, 512)
    for it in range(2):
        assert_close_scaled(outs[it].numpy(), np.asarray(want_o[it]), 1e-4)
        assert_close_scaled(lats[it].numpy(), np.asarray(want_l[it]), 1e-4)
