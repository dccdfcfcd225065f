"""The port's backbone zoo against the JAX package's, on the CPU in f32:
``ResNet`` (bottleneck, one block a stage), ``MobileFaceNet``,
``GhostNet`` (width 1, the JAX test's), ``AttentionModule`` (all three
depths), ``ResidualAttentionNet`` (``AttentionNet_56``), ``MBConvBlock``
and ``EfficientNet("b0")``, all at 112 px (the map sizes their heads are
built for) in eval mode.

Weights: each port model draws its weights from a seed, its BatchNorm
affine and running statistics and PReLU slopes are then drawn at random
(the defaults are the identity, and ResNet's last BatchNorm weight is 0),
and the JAX package's own converter (``utils/torch_convert.py::
from_torch``) builds the JAX trees from that state_dict. The port's
``from_jax`` must give the state_dict back exactly and load strictly.

Tolerances: outputs 1e-4 of the output's scale; the gradient of a seeded
random weighting of the output, per parameter, 2e-3 of that tensor's
largest JAX gradient plus 1e-6 of the largest of any tensor (a gradient
that is zero by construction, as of a BatchNorm shift before a
BatchNorm, comes out as round-off). Convolutions are summed in another
order than XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.models import attention as jatt
from stylegan_for_facerec_tpu.models import efficientnet as jeff
from stylegan_for_facerec_tpu.models import ghostnet as jghost
from stylegan_for_facerec_tpu.models import mobilefacenet as jmfn
from stylegan_for_facerec_tpu.models import resnet as jres
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.models import (attention, efficientnet,
                                               ghostnet, mobilefacenet,
                                               resnet)
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.utils.convert import from_jax

OUT_REL = 1e-4
GRAD_REL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@torch.no_grad()
def seeded(model, seed):
    """``model`` with weights from ``seed``, random BatchNorm affine and
    statistics and PReLU slopes, in eval mode."""
    init_weights(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            c = m.num_features
            m.weight.copy_(0.5 + torch.rand(c, generator=g))
            m.bias.copy_(0.1 * torch.randn(c, generator=g))
            m.running_mean.copy_(0.1 * torch.randn(c, generator=g))
            m.running_var.copy_(0.5 + torch.rand(c, generator=g))
        elif isinstance(m, torch.nn.PReLU):
            m.weight.copy_(0.1 + 0.3 * torch.rand(m.weight.shape,
                                                  generator=g))
    return model.eval()


def jax_trees(tm, jm, flatten_info=None):
    """The JAX trees of the port model's weights, through the JAX
    package's converter; ``from_jax`` must give them back exactly."""
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params, state = from_torch(jm, sd, flatten_info=flatten_info)
    back = from_jax(tm, params, state)
    want = tm.state_dict()
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    tm.load_state_dict(back, strict=True)
    return params, state


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def compare(tm, jm, params, state, x, out_nchw=False, grads=True):
    """Outputs, and the gradients of sum(out * w) for a seeded w."""
    ctx = jnn.Ctx(train=False)
    got = tm(nchw(x))
    w = np.random.RandomState(3).randn(*got.shape).astype(np.float32)
    jw = jnp.asarray(np.moveaxis(w, 1, -1) if out_nchw else w)

    def loss(p):
        out = jm.apply(p, state, jnp.asarray(x), ctx)[0]
        return jnp.sum(out * jw), out

    if not grads:
        want = np.asarray(jax.jit(lambda p: loss(p)[1])(params))
    else:
        (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params)
        want = np.asarray(want)
    if out_nchw:
        want = np.moveaxis(want, -1, 1)
    scale = np.abs(want).max()
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= OUT_REL * scale, (err, scale)
    if not grads:
        return
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


def _x(n, size=112, c=3, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, c).astype(
        np.float32)


def test_resnet_matches_jax():
    tm = seeded(resnet.ResNet(112, layers=(1, 1, 1, 1)), 0)
    jm = jres.ResNet(112, (1, 1, 1, 1))
    params, state = jax_trees(tm, jm)
    compare(tm, jm, params, state, _x(2))


def test_resnet_pooled_features_and_depths():
    """The MoCo path's pooled trunk features, and the stage depths of the
    three factories."""
    tm = seeded(resnet.ResNet(112, layers=(1, 1, 1, 1)), 1)
    jm = jres.ResNet(112, (1, 1, 1, 1))
    params, state = jax_trees(tm, jm)
    x = _x(2, seed=1)
    want, _ = jres.resnet50_pooled_features(jm, params, state,
                                            jnp.asarray(x),
                                            jnn.Ctx(train=False))
    with torch.no_grad():
        got = resnet.resnet50_pooled_features(tm, nchw(x)).numpy()
    want = np.asarray(want)
    assert got.shape == (2, 2048)
    assert np.abs(got - want).max() <= OUT_REL * np.abs(want).max()
    with torch.device("meta"):          # shapes only, no weights drawn
        for fn, layers in ((resnet.ResNet_50, (3, 4, 6, 3)),
                           (resnet.ResNet_101, (3, 4, 23, 3)),
                           (resnet.ResNet_152, (3, 8, 36, 3))):
            m = fn(112)
            assert tuple(len(getattr(m, f"layer{i}"))
                         for i in range(1, 5)) == layers
            assert m.fc.in_features == 2048 * 4 * 4
        assert resnet.ResNet_50(224).fc.in_features == 2048 * 8 * 8


def test_mobilefacenet_matches_jax():
    tm = seeded(mobilefacenet.MobileFaceNet(embedding_size=128), 2)
    jm = jmfn.MobileFaceNet(embedding_size=128)
    params, state = jax_trees(tm, jm)
    assert "conv_3.model.3.conv_dw.conv.weight" in tm.state_dict()
    compare(tm, jm, params, state, _x(2, seed=2))


def test_ghostnet_matches_jax():
    tm = seeded(ghostnet.GhostNet(width=1.0, feat_dim=128), 3)
    jm = jghost.GhostNet(width=1.0, feat_dim=128)
    params, state = jax_trees(tm, jm, {"output_layer.3": (7, 7, 960)})
    compare(tm, jm, params, state, _x(1, seed=3))


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_attention_module_matches_jax(depth):
    tm = seeded(attention.AttentionModule(32, depth), 4 + depth)
    jm = jatt.AttentionModule(32, depth)
    params, state = jax_trees(tm, jm)
    compare(tm, jm, params, state, _x(2, 14, 32, seed=4), out_nchw=True)


def test_attention_net_forward_matches_jax():
    tm = seeded(attention.AttentionNet_56(feat_dim=64), 8)
    jm = jatt.AttentionNet_56(feat_dim=64)
    params, state = jax_trees(tm, jm, {"output_layer.1": (7, 7, 2048)})
    with torch.no_grad():
        compare(tm, jm, params, state, _x(1, seed=5), grads=False)
    assert len(attention.AttentionNet_92().attention_body) == 12


@pytest.mark.parametrize("args,size", [
    (jeff.BlockArgs(1, 3, 1, 6, 24, 24), 14),    # expand, SE, skip
    (jeff.BlockArgs(1, 5, 2, 6, 24, 40), 15),    # stride 2, odd size
    (jeff.BlockArgs(1, 3, 1, 1, 32, 16), 14),    # no expansion
])
def test_mbconv_block_matches_jax(args, size):
    pargs = efficientnet.BlockArgs(*[getattr(args, f) for f in (
        "num_repeat", "kernel_size", "stride", "expand_ratio",
        "input_filters", "output_filters")])
    tm = seeded(efficientnet.MBConvBlock(pargs, drop_connect_rate=0.2), 9)
    jm = jeff.MBConvBlock(args)
    params, state = jax_trees(tm, jm)
    compare(tm, jm, params, state, _x(2, size, args.input_filters, seed=6),
            out_nchw=True)


def test_efficientnet_b0_matches_jax():
    tm = seeded(efficientnet.EfficientNet("b0", feat_dim=128), 10)
    jm = jeff.EfficientNet("b0", feat_dim=128)
    params, state = jax_trees(tm, jm, {"output_layer.3": (7, 7, 1280)})
    assert len(tm._blocks) == len(jm._scaled_blocks()) == 16
    compare(tm, jm, params, state, _x(2, seed=7))
    assert efficientnet.round_filters(32, 1.4) == jeff.round_filters(32, 1.4)
    assert efficientnet.round_repeats(2, 1.2) == 3


def test_drop_connect_and_dropout_draw_from_the_generator():
    """Train mode: drop connect zeroes whole samples of a block's branch
    (the rest scaled by 1 / keep), drawn from the module's generator;
    without one it raises."""
    block = efficientnet.MBConvBlock(
        efficientnet.BlockArgs(1, 3, 1, 1, 8, 8), drop_connect_rate=0.5)
    x = torch.randn(64, 8, 4, 4, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator"):
        block(x)
    block.drop_connect.generator = torch.Generator().manual_seed(1)
    branch = block.eval()(x) - x
    y = block.train()(x) - x
    # train-mode BatchNorm: compare against the branch in train mode
    block.drop_connect.p = 0.0
    full = block(x) - x
    kept = [(y[i] - 2 * full[i]).abs().max() < 1e-5 for i in range(64)]
    dropped = [y[i].abs().max() == 0 for i in range(64)]
    assert all(k or d for k, d in zip(kept, dropped))
    assert 16 < sum(dropped) < 48
    assert branch.shape == y.shape
