"""The port's StyleGAN1 synthesis family and ``EqualizedConv2d`` against
the JAX package on the CPU in f32: ``InstanceNorm2d``, ``AdaIN``,
``SynthesisLayer1`` (with ``up``), ``ToRGBLayer1``, the StyleGAN2-ADA
``Generator`` with ``synthesis_layer="stylegan1"`` (the JAX side of
``tests/test_ada_generator_parity.py::test_stylegan1_variant_parity``),
``EqualizedConv2d`` over resample x activation x gain, and
``smooth_downsample`` against both JAX formulations; weights by
``from_jax`` (equal to ``to_torch`` key for key, loaded strictly) and
gradients of every parameter.

Tolerances: single layers within 1e-5 of the output's largest (1e-6 for
the normalisations and the resampling), the generator within 1e-4;
gradients within 2e-3 of each tensor's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.nn import InstanceNorm2d as JInstanceNorm2d
from stylegan_for_facerec_tpu.ops import resample as jres
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.models import stylegan2_ada
from stylegan_for_facerec_torch.nn import InstanceNorm2d
from stylegan_for_facerec_torch.ops import smooth_downsample
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax

CTX = Ctx(train=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(layer, seed):
    """JAX (params, state) with the biases and noise strengths (zeros at
    init) set to seeded values."""
    params, state = layer.init(jax.random.key(seed))
    rng = np.random.RandomState(seed)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (jnp.asarray(0.2 * rng.randn(*v.shape), jnp.float32)
                 if k in ("bias", "noise_strength") else v)
                for k, v in tree.items()}

    return walk(params), state


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def grads_close(model, jgrads, state, rel=2e-3):
    want = from_jax(model, jgrads, state)
    for k, p in model.named_parameters():
        assert p.grad is not None, k
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


def test_instance_norm_and_adain_match_jax():
    rs = np.random.RandomState(0)
    x = (3 + 2 * rs.randn(2, 5, 6, 4)).astype(np.float32)
    style = rs.randn(2, 8).astype(np.float32)
    want, _ = JInstanceNorm2d(4).apply({}, {}, jnp.asarray(x), CTX)
    close(nhwc(InstanceNorm2d(4)(nchw(x))), want, 1e-6)
    want, _ = jada.AdaIN(4).apply({}, {}, (jnp.asarray(x),
                                           jnp.asarray(style)), CTX)
    got = stylegan2_ada.AdaIN(4)(nchw(x), torch.from_numpy(style))
    close(nhwc(got), want, 1e-6)
    assert not stylegan2_ada.AdaIN(4).state_dict()


@pytest.mark.parametrize("up", [True, False])
def test_synthesis_layer1_matches_jax(up):
    """Const noise; forward and the gradients of x, w and every
    parameter."""
    jl = jada.SynthesisLayer1(6, 5, 8, 8 if up else 4, up=up)
    params, state = perturbed(jl, 1)
    tl = stylegan2_ada.SynthesisLayer1(6, 5, 8, 8 if up else 4, up=up)
    load_from_jax(tl, params, state)
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 4, 6).astype(np.float32)
    w = rs.randn(2, 8).astype(np.float32)
    r = 8 if up else 4
    wt = rs.randn(2, r, r, 5).astype(np.float32)

    def f(p, xx, ww):
        y, _ = jl.apply(p, state, (xx, ww), CTX, noise_mode="const")
        return jnp.sum(y * wt), y

    (_, want), (gp, gx, gw) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                             jnp.asarray(w))
    xt = nchw(x).requires_grad_()
    wt_ = torch.from_numpy(w).requires_grad_()
    y = tl(xt, wt_, noise_mode="const")
    (y * nchw(wt)).sum().backward()
    close(nhwc(y), want, 1e-5)
    close(nhwc(xt.grad), gx, 2e-3)
    close(wt_.grad.numpy(), gw, 2e-3)
    grads_close(tl, gp, state)


def test_to_rgb_layer1_matches_jax():
    jl = jada.ToRGBLayer1(6, 3, 8)
    params, _ = perturbed(jl, 3)
    tl = stylegan2_ada.ToRGBLayer1(6, 3, 8)
    load_from_jax(tl, params, {})
    assert set(tl.state_dict()) == {"weight", "bias"}
    rs = np.random.RandomState(4)
    x = (100 * rs.randn(2, 4, 4, 6)).astype(np.float32)   # clamps at 256
    w = rs.randn(2, 8).astype(np.float32)
    want, _ = jl.apply(params, {}, (jnp.asarray(x), jnp.asarray(w)), CTX)
    close(nhwc(tl(nchw(x), torch.from_numpy(w))), want, 1e-5)
    assert np.abs(np.asarray(want)).max() == 256


@pytest.fixture(scope="module")
def gen1():
    jg = jada.Generator(z_dim=64, w_dim=64, w_num_layers=2,
                        img_resolution=32, img_channels=3,
                        synthesis_layer="stylegan1")
    params, state = perturbed(jg, 5)
    g = stylegan2_ada.Generator(64, 64, 2, 32, 3,
                                synthesis_layer="stylegan1")
    load_from_jax(g, params, state)
    return jg, params, state, g


def test_generator_from_jax_equals_to_torch(gen1):
    jg, params, state, g = gen1
    want = to_torch(jg, params, state)
    got = from_jax(g, params, state)
    assert set(got) == set(want) == set(g.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert "synthesis.blocks.0.conv0.affine.weight" in got
    assert not any(k.startswith("synthesis.blocks.0.torgb.affine")
                   for k in got)
    with pytest.raises(ValueError, match="synthesis_layer"):
        stylegan2_ada.Generator(64, 64, 2, 32, synthesis_layer="stylegan3")


@pytest.mark.parametrize("input_is_latent", [False, True])
def test_generator_matches_jax(gen1, input_is_latent):
    """Const noise, from z and from w."""
    jg, params, state, g = gen1
    rs = np.random.RandomState(6)
    z = (rs.randn(2, g.num_ws, 64) if input_is_latent
         else rs.randn(2, 64)).astype(np.float32)
    want, _ = jg.apply(params, state, jnp.asarray(z), CTX,
                       noise_mode="const", input_is_latent=input_is_latent)
    with torch.no_grad():
        got = g(torch.from_numpy(z), noise_mode="const",
                input_is_latent=input_is_latent)
    assert got.shape == (2, 3, 32, 32)
    close(nhwc(got), want, 1e-4)


def test_generator_gradients_match_jax(gen1):
    jg, params, state, g = gen1
    rs = np.random.RandomState(7)
    z = rs.randn(2, 64).astype(np.float32)
    wt = rs.randn(2, 32, 32, 3).astype(np.float32)

    def f(p):
        y, _ = jg.apply(p, state, jnp.asarray(z), CTX, noise_mode="const")
        return jnp.sum(y * wt)

    jgrads = jax.grad(f)(params)
    g.zero_grad()
    g.eval()
    y = g(torch.from_numpy(z), noise_mode="const")
    (y * nchw(wt)).sum().backward()
    grads_close(g, jgrads, state)
    g.zero_grad()


@pytest.mark.parametrize("gain", [1.0, 0.5])
@pytest.mark.parametrize("activation", ["lrelu", "linear"])
@pytest.mark.parametrize("resample", ["up", "down", "none"])
def test_equalized_conv_matches_jax(resample, activation, gain):
    """Inputs scaled so that the clamp at 256 * gain bites; forward and
    the gradients of x and the parameters."""
    jl = jada.EqualizedConv2d(4, 5, 3, activation=activation,
                              resample=resample)
    params, _ = perturbed(jl, 8)
    tl = stylegan2_ada.EqualizedConv2d(4, 5, 3, activation=activation,
                                       resample=resample)
    load_from_jax(tl, params, {})
    rs = np.random.RandomState(9)
    x = (400 * rs.randn(2, 8, 8, 4)).astype(np.float32)
    r = {"up": 16, "down": 4, "none": 8}[resample]
    wt = rs.randn(2, r, r, 5).astype(np.float32)

    def f(p, xx):
        y, _ = jl.apply(p, {}, xx, CTX, gain=gain)
        return jnp.sum(y * wt), y

    (_, want), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    assert np.abs(np.asarray(want)).max() == pytest.approx(256 * gain)
    xt = nchw(x).requires_grad_()
    y = tl(xt, gain=gain)
    (y * nchw(wt)).sum().backward()
    close(nhwc(y), want, 1e-5)
    close(nhwc(xt.grad), gx, 2e-3)
    grads_close(tl, gp, {})
    want_sd = to_torch(jl, params, {})
    assert set(want_sd) == set(tl.state_dict())


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_smooth_downsample_matches_jax(hw):
    """Against the fused JAX form and the unfused reference sequence,
    with the gradient of a weighted sum against JAX's."""
    rs = np.random.RandomState(10)
    x = rs.randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jres.smooth_downsample(jnp.asarray(x)))
    unfused = np.asarray(jres.smooth_downsample_unfused(jnp.asarray(x)))
    xt = nchw(x).requires_grad_()
    y = smooth_downsample(xt)
    close(nhwc(y), want, 1e-6)
    close(nhwc(y), unfused, 1e-6)
    wt = rs.randn(*want.shape).astype(np.float32)
    gx = jax.grad(lambda a: jnp.sum(jres.smooth_downsample(a) * wt))(
        jnp.asarray(x))
    (y * nchw(wt)).sum().backward()
    close(nhwc(xt.grad), gx, 1e-6)
