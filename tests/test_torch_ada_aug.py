"""The port's ADA pipeline (``train/ada_aug.py``, NCHW) against the JAX
package's on the CPU in f32: each group's ``apply_*`` and ``apply_ada`` on
the JAX sampler's draws (NHWC -> NCHW) and their gradients with respect
to x, within 1e-5 of the output's largest (the geometric warp's
coordinates pass through grid_sample's [-1, 1] normalisation and back);
the port's own sampler: identity bit for bit at p = 0, and each group's
fire rate at p = 0.5 within four binomial standard deviations of the
policy's rate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stage1_parity import ada_params
from stylegan_for_facerec_tpu.train import ada_aug as jada
from stylegan_for_facerec_torch.train import ada_aug

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GROUPS = ("blit", "geom", "color", "filter", "corrupt")
N, SIZE = 8, 32


def _jax_params(p, seed):
    return jada.sample_ada_params(jax.random.key(seed), N, SIZE, SIZE, 3,
                                  jnp.asarray(p, jnp.float32))


def _images(seed):
    return np.random.RandomState(seed).uniform(
        -1, 1, (N, SIZE, SIZE, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _close(got, want):
    got = got.detach().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("p", [0.5, 1.0])
@pytest.mark.parametrize("group", GROUPS)
def test_apply_group_matches_jax(group, p):
    prm = _jax_params(p, seed=3)[group]
    x = _images(4)
    want = getattr(jada, f"apply_{group}")(jnp.asarray(x), prm)
    got = getattr(ada_aug, f"apply_{group}")(
        _nchw(x), ada_params({group: prm})[group])
    _close(got, want)


@pytest.mark.parametrize("p", [0.5, 1.0])
def test_apply_ada_and_its_gradient_match_jax(p):
    prm = _jax_params(p, seed=5)
    x = _images(6)
    w = np.random.RandomState(7).randn(N, SIZE, SIZE, 3).astype(np.float32)
    want, vjp = jax.vjp(lambda xx: jada.apply_ada(xx, prm), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(w))
    xt = _nchw(x).requires_grad_()
    got = ada_aug.apply_ada(xt, ada_params(prm))
    (got_g,) = torch.autograd.grad(got, xt, _nchw(w))
    _close(got, want)
    _close(got_g, want_g)
    assert np.abs(np.asarray(want_g)).max() > 0


def test_identity_at_p0_bit_for_bit():
    x = _nchw(_images(8))
    g = torch.Generator().manual_seed(0)
    for name, fn in ada_aug.AUG_GROUPS:
        assert torch.equal(fn(g, x, 0.0), x), name
    assert torch.equal(ada_aug.ada_augment(g, x, torch.tensor(0.0)), x)


def _fire_rate(fn, p, n=800, size=12):
    x = torch.from_numpy(np.random.RandomState(0).randn(
        n, 3, size, size).astype(np.float32))
    y = fn(torch.Generator().manual_seed(1), x, torch.tensor(p))
    return (y != x).flatten(1).any(1).float().mean().item()


def test_group_fire_rates_at_half():
    """The policy's rate of each group at p: blit's flip fires on half of
    its draws, rot90 on 3/4, the translation on 8/9 (max shift 1 at 12
    px); geom has two scalings and the translation at p and two rotations
    at 1 - sqrt(1 - p); color 5 ops, filter 4 bands, corrupt 2 ops at p."""
    p, n = 0.5, 800
    q, p_rot = 1 - p, 1 - np.sqrt(1 - p)
    expect = {
        "blit": 1 - (1 - 0.5 * p) * (1 - 0.75 * p) * (1 - p * 8 / 9),
        "geom": 1 - q ** 3 * (1 - p_rot) ** 2,
        "color": 1 - q ** 5, "filter": 1 - q ** 4, "corrupt": 1 - q ** 2}
    for name, fn in ada_aug.AUG_GROUPS:
        rate = _fire_rate(fn, p, n)
        sd = np.sqrt(expect[name] * (1 - expect[name]) / n)
        assert abs(rate - expect[name]) <= 4 * sd, (name, rate, expect[name])


def test_sampler_draws_on_the_generator():
    """The same generator state gives the same draws; p as a tensor."""
    a = ada_aug.sample_ada_params(torch.Generator().manual_seed(3), 4, 3, 16,
                                  16, torch.tensor(0.7))
    b = ada_aug.sample_ada_params(torch.Generator().manual_seed(3), 4, 3, 16,
                                  16, 0.7)
    for grp in a:
        for k in a[grp]:
            assert torch.equal(a[grp][k], b[grp][k]), (grp, k)
