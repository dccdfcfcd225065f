"""The port's stage-2 losses against the JAX package's, on the CPU.

LPIPS (alex and vgg): the JAX module's random weights carried over by
``from_jax``; the value and its gradient with respect to the first image,
at 1e-5 of scale (f32 convolutions summed in another order than XLA's).
The identity losses at 1e-5 (the same f32 operations, sums in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.losses import identity as jid
from stylegan_for_facerec_tpu.losses import perceptual as jperc
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_torch.losses import (LPIPS, make_moco_extractor,
                                               normalize_activation,
                                               similarity_loss, w_norm_loss)
from stylegan_for_facerec_torch.nn import init_weights
from stylegan_for_facerec_torch.utils.convert import from_jax


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores, and
    torch's thread pool contending with them slows small kernels by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("net_type,size", [("alex", 64), ("vgg", 32)])
def test_lpips_value_and_grad_match_jax(net_type, size):
    jm = jperc.LPIPS(net_type)
    params, state = jm.init(jax.random.key(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)

    def jfn(a):
        return jm.apply(params, {}, (a, jnp.asarray(y)), Ctx())[0]

    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(x))

    tm = LPIPS(net_type)
    tm.load_state_dict(from_jax(tm, params, state), strict=True)
    tm.requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(got, xt)
    assert got.dtype == torch.float32 and got.item() > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    scale = float(np.abs(want_grad).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), rtol=0,
                               atol=1e-5 * scale)


def test_lpips_layout_and_seeded_init():
    """torchvision ``features`` indices and ``lin.{i}`` (1, C, 1, 1)."""
    lp = LPIPS("alex")
    keys = set(lp.state_dict())
    assert {"net.0.weight", "net.3.bias", "net.10.weight",
            "lin.4.weight"} <= keys
    assert lp.lin[1].weight.shape == (1, 192, 1, 1)
    init_weights(lp, torch.Generator().manual_seed(0))
    assert (lp.lin[0].weight > 0).all()
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    assert lp(x, x).item() == 0.0
    with pytest.raises(ValueError, match="alex|vgg"):
        LPIPS("resnet")


def test_normalize_activation_matches_jax():
    x = np.random.RandomState(5).randn(2, 4, 3, 7).astype(np.float32)
    want = np.asarray(jperc.normalize_activation(jnp.asarray(x)))
    got = normalize_activation(torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               rtol=1e-6, atol=1e-6)


def test_w_norm_loss_matches_jax():
    rng = np.random.RandomState(6)
    lat = rng.randn(3, 10, 512).astype(np.float32)
    avg = rng.randn(10, 512).astype(np.float32)
    for start in (True, False):
        want = float(jid.w_norm_loss(jnp.asarray(lat), jnp.asarray(avg),
                                     start))
        got = w_norm_loss(torch.from_numpy(lat), torch.from_numpy(avg),
                          start).item()
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_similarity_loss_with_moco_extractor_matches_jax():
    """MoCo path: resize to 224, a fixed linear embedding, L2 norm; then
    the shared loss body."""
    rng = np.random.RandomState(7)
    w = rng.randn(3, 16).astype(np.float32)
    imgs = [rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
            for _ in range(3)]

    def jfeat(x):
        return jnp.mean(x, axis=(1, 2)) @ jnp.asarray(w) + jnp.sum(
            x[:, ::50, ::50, 0], axis=(1, 2))[:, None]

    def tfeat(x):
        return x.mean(dim=(1, 2)) @ torch.from_numpy(w) + x[
            :, ::50, ::50, 0].sum(dim=(1, 2))[:, None]

    jl, jsim, jlogs = jid.similarity_loss(
        jid.make_moco_extractor(jfeat), *(jnp.asarray(i) for i in imgs))
    tl, tsim, tlogs = similarity_loss(
        make_moco_extractor(tfeat), *(torch.from_numpy(i) for i in imgs))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsim.item(), float(jsim), rtol=1e-5,
                               atol=1e-6)
    for k in ("diff_target", "diff_input", "diff_views"):
        np.testing.assert_allclose(tlogs[k].numpy(), np.asarray(jlogs[k]),
                                   rtol=1e-5, atol=1e-6)
