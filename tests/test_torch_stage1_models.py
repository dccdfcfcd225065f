"""The port's stage-1 modules against the JAX package on the CPU in f32:
the rosinality ``Discriminator`` (forward and input gradient, weights by
``from_jax``, which equals ``to_torch`` key for key), the mapping
network's train-mode ``w_avg`` EMA and truncation, and
``fused_leaky_relu`` / ``clamp_gain``.

Tolerances: 1e-4 of the output's largest for the discriminator (11 conv
layers summed in other orders), 1e-6 relative for the mapping network
(two small dense layers) and 1e-6 of scale for the activation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import stylegan2 as jsg2
from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.ops import fused_act as jfa
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.models import stylegan2, stylegan2_ada
from stylegan_for_facerec_torch.ops import fused_act
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _perturb(tree, rs):
    """Every zero-initialised bias set to small random values, so the bias
    paths count."""
    if isinstance(tree, dict):
        return {k: (jnp.asarray(rs.normal(0, 0.1, v.shape), jnp.float32)
                    if k == "bias" else _perturb(v, rs))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module")
def disc():
    jd = jsg2.Discriminator(size=32)
    params, _ = jd.init(jax.random.key(3))
    params = _perturb(params, np.random.RandomState(4))
    d = stylegan2.Discriminator(size=32)
    load_from_jax(d, params, {})
    return jd, params, d


def test_discriminator_from_jax_equals_to_torch(disc):
    jd, params, d = disc
    want = to_torch(jd, params, {})
    got = from_jax(d, params, {})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("batch", [4, 8])
def test_discriminator_forward_and_input_grad_match_jax(disc, batch):
    """Batch 8 runs the minibatch stddev over 2 groups of 4."""
    jd, params, d = disc
    rs = np.random.RandomState(batch)
    x = rs.uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32)
    w = rs.randn(batch, 1).astype(np.float32)

    def f(xx):
        y, _ = jd.apply(params, {}, xx, Ctx(train=True))
        return jnp.sum(y * w), y

    (_, want), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = d(xt)
    (gt,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    want, gx = np.asarray(want), np.asarray(gx)
    assert y.shape == (batch, 1)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(gt.permute(0, 2, 3, 1).numpy(), gx, rtol=0,
                               atol=1e-4 * np.abs(gx).max())


@pytest.mark.parametrize("layer", ["blur", "downsample"])
def test_blur_and_downsample_match_jax(layer):
    """The discriminator's blur (pad (2, 1), kernel [1, 3, 3, 1]) and
    ``Downsample`` (blur and keep every 2nd sample)."""
    if layer == "blur":
        jl, tl = (jsg2.Blur((1, 3, 3, 1), (2, 1)),
                  stylegan2.Blur((1, 3, 3, 1), (2, 1)))
    else:
        jl, tl = jsg2.Downsample(), stylegan2.Downsample()
    x = np.random.RandomState(9).randn(2, 12, 12, 5).astype(np.float32)
    want, _ = jl.apply({}, {}, jnp.asarray(x), Ctx())
    got = tl(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = np.asarray(want)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6 * np.abs(want).max())


def test_discriminator_child_names():
    """The reference's torch names: blur 0, conv 1, activation bias 2 in
    a downsampling ConvLayer; the skip has neither bias nor activation."""
    keys = set(stylegan2.Discriminator(size=32).state_dict())
    for k in ("convs.0.0.weight", "convs.0.1.bias", "convs.1.conv1.0.weight",
              "convs.1.conv1.1.bias", "convs.1.conv2.1.weight",
              "convs.1.conv2.2.bias", "convs.1.skip.1.weight",
              "final_conv.0.weight", "final_conv.1.bias",
              "final_linear.0.weight", "final_linear.0.bias",
              "final_linear.1.weight", "final_linear.1.bias"):
        assert k in keys, k
    assert not any(k.startswith("convs.1.skip.2") or k.endswith("kernel")
                   for k in keys)


@pytest.fixture(scope="module")
def mapping():
    jm = jada.MappingNetwork(z_dim=64, w_dim=64, num_ws=6, num_layers=2)
    params, state = jm.init(jax.random.key(5))
    state = {"w_avg": jnp.asarray(np.random.RandomState(6).normal(
        0, 0.5, (64,)), jnp.float32)}
    z = np.random.RandomState(7).randn(5, 64).astype(np.float32)
    return jm, params, state, z


def _port_mapping(params, state, **kw):
    m = stylegan2_ada.MappingNetwork(z_dim=64, w_dim=64, num_ws=6,
                                     num_layers=2, **kw)
    return load_from_jax(m, params, state)


def test_mapping_w_avg_ema_in_train_mode(mapping):
    jm, params, state, z = mapping
    want, new_state = jm.apply(params, state, jnp.asarray(z),
                               Ctx(train=True))
    m = _port_mapping(params, state).train()
    got = m(torch.from_numpy(z))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(m.w_avg.numpy(),
                               np.asarray(new_state["w_avg"]), rtol=1e-6,
                               atol=1e-7)
    assert not np.allclose(m.w_avg.numpy(), np.asarray(state["w_avg"]))


def test_mapping_skip_w_avg_update_and_eval_leave_it(mapping):
    jm, params, state, z = mapping
    _, s_skip = jm.apply(params, state, jnp.asarray(z), Ctx(train=True),
                         skip_w_avg_update=True)
    np.testing.assert_array_equal(np.asarray(s_skip["w_avg"]),
                                  np.asarray(state["w_avg"]))
    m = _port_mapping(params, state).train()
    m(torch.from_numpy(z), skip_w_avg_update=True)
    np.testing.assert_array_equal(m.w_avg.numpy(), np.asarray(state["w_avg"]))
    m.eval()(torch.from_numpy(z))
    np.testing.assert_array_equal(m.w_avg.numpy(), np.asarray(state["w_avg"]))


@pytest.mark.parametrize("cutoff", [None, 3])
def test_mapping_truncation_matches_jax(mapping, cutoff):
    jm, params, state, z = mapping
    want, _ = jm.apply(params, state, jnp.asarray(z), Ctx(train=False),
                       truncation_psi=0.7, truncation_cutoff=cutoff)
    m = _port_mapping(params, state).eval()
    got = m(torch.from_numpy(z), truncation_psi=0.7,
            truncation_cutoff=cutoff)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    full = m(torch.from_numpy(z))
    if cutoff is not None:
        assert torch.equal(got[:, cutoff:], full[:, cutoff:])
        assert not torch.allclose(got[:, :cutoff], full[:, :cutoff])


def test_mapping_truncation_raises_without_w_avg(mapping):
    _, params, _, z = mapping
    jm = jada.MappingNetwork(z_dim=64, w_dim=64, num_ws=6, num_layers=2,
                             w_avg_beta=None)
    _, jstate = jm.init(jax.random.key(5))
    assert "w_avg" not in jstate
    with pytest.raises(ValueError, match="w_avg"):
        jm.apply(params, jstate, jnp.asarray(z), Ctx(train=False),
                 truncation_psi=0.5)
    m = _port_mapping(params, {}, w_avg_beta=None)
    assert "w_avg" not in m.state_dict()
    m(torch.from_numpy(z))                      # psi 1: fine
    with pytest.raises(ValueError, match="w_avg"):
        m(torch.from_numpy(z), truncation_psi=0.5)


@pytest.mark.parametrize("shape", [(6, 512), (2, 5, 7, 9)])
def test_fused_leaky_relu_matches_jax(shape):
    """2-D (N, C), as final_linear.0 feeds it, and 4-D NCHW; value and the
    gradients of x and the bias."""
    rs = np.random.RandomState(len(shape))
    x = rs.randn(*shape).astype(np.float32)
    b = rs.randn(shape[1]).astype(np.float32)
    g = rs.randn(*shape).astype(np.float32)
    perm = (0, 2, 3, 1) if len(shape) == 4 else (0, 1)
    xj, gj = (jnp.asarray(np.transpose(a, perm)) for a in (x, g))

    def f(xx, bb):
        return jnp.sum(jfa.fused_leaky_relu(xx, bb) * gj)

    want = np.asarray(jfa.fused_leaky_relu(xj, jnp.asarray(b)))
    gxj, gbj = jax.grad(f, argnums=(0, 1))(xj, jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fused_act.fused_leaky_relu(xt, bt)
    gx, gb = torch.autograd.grad(y, (xt, bt), torch.from_numpy(g))
    for got, w in ((y.detach(), want), (gx, np.asarray(gxj))):
        np.testing.assert_allclose(np.transpose(got.numpy(), perm), w,
                                   rtol=0, atol=1e-6 * np.abs(w).max())
    np.testing.assert_allclose(gb.numpy(), np.asarray(gbj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(gbj)).max())


def test_fused_leaky_relu_is_bias_act_and_clamp_gain():
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    b = torch.randn(4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(fused_act.fused_leaky_relu(x, b),
                       fused_act.bias_act(x, b, act="lrelu", gain=1.0))
    assert torch.equal(fused_act.fused_leaky_relu(x, b, scale=2.0),
                       fused_act.bias_act(x, b, act="lrelu",
                                          gain=2.0 / np.sqrt(2)))
    with pytest.raises(ValueError):
        fused_act.fused_leaky_relu(x, b, negative_slope=0.1)
    want = np.asarray(jfa.clamp_gain(jnp.asarray(x.numpy() * 100), 1.5, 40.0))
    np.testing.assert_array_equal(
        fused_act.clamp_gain(x * 100, 1.5, 40.0).numpy(), want)
