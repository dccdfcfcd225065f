"""The port's demographic-adaptive (GAC) modules against the JAX
package's, on the CPU in f32: ``AdaConv2dFaster`` (its groups 0 and 1
share kernel 0), ``AdaConv2dGAC`` with ``fused_groups=(2,)`` (group 2
falls back to kernel 0) and without adaptation, ``AttBlock``,
``Conv2dExtended``, ``IRBlockGAC`` and ``gac_resnet18`` (adaptive convs
and attention, 2 style heads, 112 px), with labels 0-3 in every batch.

Weights: the port's, drawn from a seed (the attention gates and the
BatchNorm statistics then at random), carried to the JAX layout by the
JAX package's converter for the standard layers and by hand for the
adaptive kernels and gates (``kernel_base`` (oc, ic, k, k) -> (k, k, ic,
oc), ``kernel_mask`` (G, 1, ic, k, k) -> (G, k, k, ic, 1)); the port's
``from_jax`` must give the state_dict back exactly.

Tolerances: outputs 1e-4 of the output's scale; gradients of a seeded
random weighting of the output 2e-3 of each tensor's largest JAX
gradient plus 1e-6 of the largest of any tensor (the zoo's rule). The
port convolves each label's rows with that label's kernel; the JAX
package convolves every row with every kernel and picks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.models import gac as jgac
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.models import gac
from stylegan_for_facerec_torch.utils.convert import from_jax
from test_torch_backbone_zoo import GRAD_REL, OUT_REL, nchw, seeded

LABELS = np.array([0, 1, 2, 3, 1, 0, 3, 2])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _insert(tree, name, value):
    """Put ``value`` at the port module path ``name`` of a JAX tree (a
    child such as ``layer1.0`` is one key there)."""
    parts, node, i = name.split(".") if name else [], tree, 0
    while i < len(parts):
        if i + 1 < len(parts) and f"{parts[i]}.{parts[i + 1]}" in node:
            key, i = f"{parts[i]}.{parts[i + 1]}", i + 2
        else:
            key, i = parts[i], i + 1
        node = node.setdefault(key, {})
    node.update(value)


def gac_trees(tm, jm):
    """JAX (params, state) of the port module's weights."""
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, state = from_torch(jm, sd, strict=False)
    for name, m in tm.named_modules():
        if isinstance(m, gac.AdaConv2dFaster):
            _insert(params, name, {
                "kernel_base": np.transpose(m.kernel_base.detach().numpy(),
                                            (2, 3, 1, 0)),
                "kernel_mask": np.transpose(m.kernel_mask.detach().numpy(),
                                            (0, 3, 4, 2, 1))})
        elif isinstance(m, gac.AttBlock):
            _insert(params, name,
                    {"att_channel": m.att_channel.detach().numpy()})
    back = from_jax(tm, params, state)
    for k, v in tm.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    tm.load_state_dict(back, strict=True)
    return params, state


@torch.no_grad()
def seeded_gac(model, seed):
    seeded(model, seed)
    g = torch.Generator().manual_seed(seed + 2)
    for m in model.modules():
        if isinstance(m, gac.AttBlock):
            m.att_channel.normal_(0.0, 1.0, generator=g)
    return model


def compare(tm, jm, params, state, x, labels, nhwc_out=True):
    ctx = jnn.Ctx(train=False)
    got = tm(nchw(x), torch.from_numpy(labels))
    w = np.random.RandomState(3).randn(*got.shape).astype(np.float32)
    jw = jnp.asarray(np.moveaxis(w, 1, -1) if nhwc_out else w)

    def loss(p):
        out = jm.apply(p, state, (jnp.asarray(x), jnp.asarray(labels)),
                       ctx)[0]
        return jnp.sum(out * jw), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = np.asarray(want)
    if nhwc_out:
        want = np.moveaxis(want, -1, 1)
    scale = np.abs(want).max()
    assert np.abs(got.detach().numpy() - want).max() <= OUT_REL * scale
    (got * torch.from_numpy(w)).sum().backward()
    want_g = from_jax(tm, jgrads, state)
    names = [k for k, _ in tm.named_parameters()]
    floor = 1e-6 * max(float(want_g[k].abs().max()) for k in names)
    worst = []
    for k, p in tm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        tol = GRAD_REL * float(want_g[k].abs().max()) + floor
        worst.append((float((g - want_g[k]).abs().max()) / tol, k))
    worst.sort(reverse=True)
    assert worst[0][0] <= 1.0, worst[:5]
    return got


def _x(n, size, c, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, c).astype(
        np.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_adaconv_faster_matches_jax(stride):
    tm = seeded_gac(gac.AdaConv2dFaster(4, 8, 12, 3, stride, 1), 0)
    jm = jgac.AdaConv2dFaster(4, 8, 12, 3, stride, 1)
    params, state = gac_trees(tm, jm)
    got = compare(tm, jm, params, state, _x(8, 10, 8), LABELS)
    # the quirk: a label-1 row is convolved with kernel 0, as label 0's
    x = nchw(_x(8, 10, 8))
    kernel0 = tm.kernel_base * tm.kernel_mask[0]
    with torch.no_grad():
        want = torch.nn.functional.conv2d(x[1:2], kernel0, stride=stride,
                                          padding=1)
    torch.testing.assert_close(got[1:2].detach(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("fused,adap", [((2,), True), ((), True),
                                        ((), False)])
def test_adaconv_gac_matches_jax(fused, adap):
    tm = seeded_gac(gac.AdaConv2dGAC(4, 8, 12, 3, 1, 1, adap=adap,
                                     fused_groups=fused), 1)
    jm = jgac.AdaConv2dGAC(4, 8, 12, 3, 1, 1, adap=adap, fused_groups=fused)
    params, state = gac_trees(tm, jm)
    got = compare(tm, jm, params, state, _x(8, 9, 8, seed=1), LABELS)
    if adap:
        # label 1 has its own kernel here; with group 2 fused, a label-2
        # row is convolved with kernel 0
        x = nchw(_x(8, 9, 8, seed=1))
        k = 0 if fused else 2
        kernel = tm.kernel_base * tm.kernel_mask[k]
        with torch.no_grad():
            want = torch.nn.functional.conv2d(x[2:3], kernel, padding=1)
        torch.testing.assert_close(got[2:3].detach(), want, rtol=1e-5,
                                   atol=1e-5)


def test_adaconv_group_subsets():
    """A batch with labels 1 and 3 only, and with one row, give each row
    what the whole batch gives it."""
    tm = seeded_gac(gac.AdaConv2dGAC(4, 8, 12, 3, 1, 1), 2)
    x = nchw(_x(8, 9, 8, seed=2))
    labels = torch.from_numpy(LABELS)
    with torch.no_grad():
        full = tm(x, labels)
        sub = [i for i in range(8) if LABELS[i] in (1, 3)]
        torch.testing.assert_close(tm(x[sub], labels[sub]), full[sub],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(tm(x[5:6], labels[5:6]), full[5:6],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("init", ["ones", "xavier"])
def test_attblock_matches_jax(init):
    tm = gac.AttBlock(8, 4, init_strategy=init)
    seeded(tm, 3)
    if init == "ones":
        seeded_gac(tm, 3)
    jm = jgac.AttBlock(8, 4, init_strategy=init)
    params, state = gac_trees(tm, jm)
    compare(tm, jm, params, state, _x(8, 5, 8, seed=3), LABELS)


def test_conv2d_extended_matches_jax():
    tm = seeded(gac.Conv2dExtended(4, 8, 12, 3, 1, 1), 4)
    jm = jgac.Conv2dExtended(4, 8, 12, 3, 1, 1)
    params, state = gac_trees(tm, jm)
    compare(tm, jm, params, state, _x(8, 7, 8, seed=4), LABELS)


@pytest.mark.parametrize("stride,adap,att", [(2, True, True),
                                             (1, False, False)])
def test_ir_block_gac_matches_jax(stride, adap, att):
    cin = 16 if stride == 2 else 32
    tm = seeded_gac(gac.IRBlockGAC(cin, 32, stride, 4, adap, att), 5)
    jm = jgac.IRBlockGAC(cin, 32, stride, 4, adap, att)
    params, state = gac_trees(tm, jm)
    compare(tm, jm, params, state, _x(8, 8, cin, seed=5), LABELS)


def test_gac_resnet18_matches_jax():
    kw = dict(ndemog=4, n_styles=2, adap=True, use_att=True)
    tm = seeded_gac(gac.gac_resnet18(**kw), 6)
    jm = jgac.gac_resnet18(**kw)
    params, state = gac_trees(tm, jm)
    labels = np.array([2, 0, 3, 1])
    got = compare(tm, jm, params, state, _x(4, 112, 6, seed=6), labels,
                  nhwc_out=False)
    assert got.shape == (4, 2, 512)
    assert [len(getattr(tm, f"layer{i}")) for i in range(1, 5)] == \
        [2, 2, 2, 2]
    with torch.device("meta"):
        assert len(gac.gac_resnet50(n_styles=1).layer3) == 14
