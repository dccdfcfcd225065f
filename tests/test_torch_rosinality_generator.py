"""The port's rosinality StyleGAN2 generator against the JAX package on the
CPU in f32: ``ModulatedConv2d`` in its three branches, ``StyledConv``,
``ToRGB``, ``Upsample``, ``pixel_norm`` and ``Generator`` (const noise,
given noise, style mixing, truncation, w input, returned latents, the
style MLP), weights by ``from_jax`` (equal to ``to_torch`` key for key,
loaded strictly), gradients of every parameter.

Tolerances: forwards within 1e-5 of the output's largest for single
layers and 1e-4 for the generator (a dozen convolutions summed in other
orders); gradients within 2e-3 of each tensor's largest element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import stylegan2 as jsg2
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch import models
from stylegan_for_facerec_torch.models import stylegan2
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax

CTX = Ctx(train=False)
SIZE, STYLE_DIM, N_MLP = 16, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed(layer, seed):
    """JAX (params, state) with every bias and noise weight (zeros at
    init) set to seeded values, so their paths count."""
    params, state = layer.init(jax.random.key(seed))
    rng = np.random.RandomState(seed)

    def walk(tree, noise=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k == "noise")
            elif k == "bias" or noise:
                out[k] = jnp.asarray(0.2 * rng.randn(*v.shape), jnp.float32)
            else:
                out[k] = v
        return out

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
    """Every parameter's gradient against JAX's, carried into the port's
    layout by ``from_jax``; within ``rel`` of the tensor's largest."""
    want = from_jax(model, jgrads, state)
    n = 0
    for k, p in model.named_parameters():
        assert p.grad is not None, k
        w = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
        n += 1
    return n


@pytest.fixture(scope="module")
def gen():
    jg = jsg2.Generator(size=SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP)
    params, state = perturbed(jg, 0)
    g = stylegan2.Generator(SIZE, STYLE_DIM, N_MLP)
    load_from_jax(g, params, state)
    return jg, params, state, g


def test_from_jax_equals_to_torch_and_loads_strictly(gen):
    jg, params, state, g = gen
    want = to_torch(jg, params, state)
    got = from_jax(g, params, state)
    assert set(got) == set(want) == set(g.state_dict())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("style.1.weight", "input.input", "noises.noise_0",
              "conv1.activate.bias", "convs.0.conv.weight",
              "to_rgbs.0.bias", "convs.1.noise.weight"):
        assert k in got, k
    assert got["convs.0.conv.weight"].dim() == 5
    assert tuple(got["to_rgb1.bias"].shape) == (1, 3, 1, 1)
    assert tuple(got["noises.noise_2"].shape) == (1, 1, 8, 8)
    assert models.GeneratorRosinality is stylegan2.Generator


@pytest.mark.parametrize("demodulate", [True, False])
@pytest.mark.parametrize("branch", ["up", "down", "plain"])
def test_modulated_conv_matches_jax(branch, demodulate):
    """Forward, and the gradients of x, the style and every parameter;
    the upsample branch is a transposed convolution (no kernel flip) and a
    blur with pad (1, 1)."""
    kw = dict(demodulate=demodulate, upsample=branch == "up",
              downsample=branch == "down")
    jl = jsg2.ModulatedConv2d(6, 5, 3, 8, **kw)
    params, _ = perturbed(jl, 1)
    tl = stylegan2.ModulatedConv2d(6, 5, 3, 8, **kw)
    load_from_jax(tl, params, {})
    rs = np.random.RandomState(2)
    x = rs.randn(2, 8, 8, 6).astype(np.float32)
    s = rs.randn(2, 8).astype(np.float32)
    out_hw = {"up": 16, "down": 4, "plain": 8}[branch]
    w = rs.randn(2, out_hw, out_hw, 5).astype(np.float32)

    def f(p, xx, ss):
        y, _ = jl.apply(p, {}, (xx, ss), CTX)
        return jnp.sum(y * w), y

    (_, want), (gp, gx, gs) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x),
                                             jnp.asarray(s))
    xt = nchw(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    y = tl(xt, st)
    (y * nchw(w)).sum().backward()
    assert y.shape == (2, 5, out_hw, out_hw)
    close(nhwc(y), want, 1e-5)
    close(nhwc(xt.grad), gx, 2e-3)
    close(st.grad.numpy(), gs, 2e-3)
    grads_close(tl, gp, {})


def test_styled_conv_with_given_noise():
    jl = jsg2.StyledConv(6, 5, 3, 8, upsample=True)
    params, _ = perturbed(jl, 3)
    tl = stylegan2.StyledConv(6, 5, 3, 8, upsample=True)
    load_from_jax(tl, params, {})
    rs = np.random.RandomState(4)
    x = rs.randn(2, 4, 4, 6).astype(np.float32)
    s = rs.randn(2, 8).astype(np.float32)
    noise = rs.randn(2, 8, 8, 1).astype(np.float32)
    want, _ = jl.apply(params, {}, (jnp.asarray(x), jnp.asarray(s)), CTX,
                       noise=jnp.asarray(noise))
    got = tl(nchw(x), torch.from_numpy(s), nchw(noise))
    close(nhwc(got), want, 1e-5)
    with pytest.raises(ValueError, match="Generator"):
        tl(nchw(x), torch.from_numpy(s))


def test_to_rgb_with_skip_and_upsample():
    jl = jsg2.ToRGB(6, 8)
    params, _ = perturbed(jl, 5)
    tl = stylegan2.ToRGB(6, 8)
    load_from_jax(tl, params, {})
    rs = np.random.RandomState(6)
    x = rs.randn(2, 8, 8, 6).astype(np.float32)
    s = rs.randn(2, 8).astype(np.float32)
    skip = rs.randn(2, 4, 4, 3).astype(np.float32)
    want, _ = jl.apply(params, {}, (jnp.asarray(x), jnp.asarray(s)), CTX,
                       skip=jnp.asarray(skip))
    got = tl(nchw(x), torch.from_numpy(s), nchw(skip))
    close(nhwc(got), want, 1e-5)
    up, _ = jsg2.Upsample().apply({}, {}, jnp.asarray(skip), CTX)
    close(nhwc(stylegan2.Upsample()(nchw(skip))), up, 1e-6)
    z = rs.randn(3, 8).astype(np.float32)
    close(stylegan2.pixel_norm(torch.from_numpy(z)).numpy(),
          jsg2.pixel_norm(jnp.asarray(z)), 1e-6)


def _latents(seed, n=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, STYLE_DIM).astype(np.float32) for _ in range(2)]


CASES = {
    "z_const_noise": dict(),
    "z_mixing": dict(mix=True, inject_index=3),
    "w_mixing": dict(mix=True, inject_index=2, input_is_latent=True),
    "z_truncation": dict(truncation=0.7),
    "w_latents": dict(input_is_latent=True, return_latents=True),
    "w_plus": dict(w_plus=True, input_is_latent=True, return_latents=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_matches_jax(gen, case):
    """Const noise (the stored buffers) in every case; style mixing at an
    index, truncation toward a given latent, w input, an (N, n_latent, D)
    w+ input, returned latents."""
    jg, params, state, g = gen
    kw = dict(CASES[case])
    mix, w_plus = kw.pop("mix", False), kw.pop("w_plus", False)
    a, b = _latents(7)
    styles = [a, b] if mix else [a]
    if w_plus:
        styles = [np.random.RandomState(8).randn(
            2, jg.n_latent, STYLE_DIM).astype(np.float32)]
    if "truncation" in kw:
        kw["truncation_latent"] = np.random.RandomState(9).randn(
            1, STYLE_DIM).astype(np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want, _ = jg.apply(params, state, [jnp.asarray(s) for s in styles], CTX,
                       randomize_noise=False, **jkw)
    with torch.no_grad():
        got = g([torch.from_numpy(s) for s in styles],
                randomize_noise=False, **tkw)
    if kw.get("return_latents"):
        (want, want_lat), (got, got_lat) = want, got
        assert got_lat.shape == (2, g.n_latent, STYLE_DIM)
        close(got_lat.numpy(), want_lat, 1e-5)
    assert got.shape == (2, 3, SIZE, SIZE)
    close(nhwc(got), want, 1e-4)


def test_generator_given_noise_and_style_mlp(gen):
    jg, params, state, g = gen
    rs = np.random.RandomState(10)
    (a, _) = _latents(11)
    noise = [rs.randn(2, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2),
                      1).astype(np.float32) for i in range(g.num_layers)]
    want, _ = jg.apply(params, state, [jnp.asarray(a)], CTX,
                       noise=[jnp.asarray(n) for n in noise])
    with torch.no_grad():
        got = g([torch.from_numpy(a)], noise=[nchw(n) for n in noise])
        w = g.style_mlp(torch.from_numpy(a))
    close(nhwc(got), want, 1e-4)
    close(w.numpy(), jg.style_mlp(params, jnp.asarray(a), CTX), 1e-5)


def test_generator_gradients_match_jax(gen):
    """A weighted image sum from z with style mixing: every parameter's
    gradient (the MLP's through B1b's plain version) within 2e-3 of the
    tensor's largest."""
    jg, params, state, g = gen
    a, b = _latents(12)
    wt = np.random.RandomState(13).randn(2, SIZE, SIZE, 3).astype(
        np.float32)

    def f(p):
        y, _ = jg.apply(p, state, [jnp.asarray(a), jnp.asarray(b)], CTX,
                        inject_index=3, randomize_noise=False)
        return jnp.sum(y * wt)

    jgrads = jax.grad(f)(params)
    g.zero_grad()
    y = g([torch.from_numpy(a), torch.from_numpy(b)], inject_index=3,
          randomize_noise=False)
    (y * nchw(wt)).sum().backward()
    assert grads_close(g, jgrads, state) == len(list(g.parameters()))
    g.zero_grad()


def test_random_draws_come_from_the_generator(gen):
    """Random noise and the random crossover draw from an explicit
    torch.Generator, and raise without one; the same seed gives the same
    image."""
    _, _, _, g = gen
    a, b = (torch.from_numpy(v) for v in _latents(14))
    with torch.no_grad():
        with pytest.raises(ValueError, match="Generator"):
            g([a])
        with pytest.raises(ValueError, match="Generator"):
            g([a, b], randomize_noise=False)
        one = g([a, b], generator=torch.Generator().manual_seed(3),
                return_latents=True)
        two = g([a, b], generator=torch.Generator().manual_seed(3),
                return_latents=True)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    wa, wb = g.style_mlp(a), g.style_mlp(b)
    lat = one[1]
    first = [bool(torch.equal(lat[:, i], wa)) for i in range(g.n_latent)]
    idx = first.index(False)
    assert 1 <= idx < g.n_latent and not any(first[idx:])
    assert torch.equal(lat[:, idx:], wb[:, None].expand_as(lat[:, idx:]))


def test_mean_latent(gen):
    _, _, _, g = gen
    m = g.mean_latent(64, torch.Generator().manual_seed(5))
    z = torch.randn((64, STYLE_DIM), generator=torch.Generator().manual_seed(
        5))
    assert m.shape == (1, STYLE_DIM)
    with torch.no_grad():
        torch.testing.assert_close(m, g.style_mlp(z).mean(0, keepdim=True))
