"""Gradients of the port's kernels' autograd Functions against the JAX
package, on the CPU (the Functions run their plain versions there).

B1 (``bias_act``): dx and db against ``jax.vjp`` of the Pallas op
``fused_bias_act_pallas`` in interpret mode (its custom VJP runs
``_fba_grad_kernel``) at C = 128, and of the jnp ``bias_act`` at C = 3 and
64. Inputs are scaled by 200 so that the clamp at 256 saturates on many
elements. Tolerance 1e-6 relative + 1e-6: the same f32 operations; db sums
in another order (1e-5 relative for it).
B2 (``smooth_upsample``): the input gradient against ``jax.vjp`` of
``ops/resample.py::smooth_upsample`` at tolerance 1e-5 (the taps are summed
in another order).
Both Functions are also checked with ``gradcheck`` and ``gradgradcheck`` in
f64.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.ops import fused_act as jfa
from stylegan_for_facerec_tpu.ops import resample as jresample
from stylegan_for_facerec_torch.ops import (bias_act, bias_act_grad,
                                            bias_act_grad_plain,
                                            smooth_upsample,
                                            smooth_upsample_grad,
                                            smooth_upsample_grad_plain)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores, and
    torch's thread pool contending with them slows small kernels by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _port_vjp(x, b, g, act, gain, clamp):
    xt = nchw(x).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = bias_act(xt, bt, act, gain, clamp)
    dx, db = torch.autograd.grad(y, (xt, bt), nchw(g))
    return nhwc(dx), db.numpy()


def _inputs(seed, c):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, 5, 6, c) * 200).astype(np.float32)
    b = (rng.randn(c) * 10).astype(np.float32)
    g = rng.randn(2, 5, 6, c).astype(np.float32)
    return x, b, g


@pytest.mark.parametrize("clamp", [None, 256.0])
def test_bias_act_grad_matches_pallas_vjp(clamp):
    x, b, g = _inputs(0, 128)
    _, vjp = jax.vjp(lambda x, b: jfa.fused_bias_act_pallas(
        x, b, 0.2, math.sqrt(2), clamp), jnp.asarray(x), jnp.asarray(b))
    want_dx, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dx, db = _port_vjp(x, b, g, "lrelu", 1.0, clamp)
    if clamp is not None:
        assert (want_dx == 0).mean() > 0.1   # the clamp saturates
    np.testing.assert_allclose(dx, want_dx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db, want_db, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("act,gain,clamp", [("lrelu", 1.0, 256.0),
                                            ("lrelu", 1.0, None),
                                            ("linear", 2.0, 100.0)])
def test_bias_act_grad_matches_jnp_vjp(c, act, gain, clamp):
    x, b, g = _inputs(1, c)
    _, vjp = jax.vjp(lambda x, b: jfa.bias_act(x, b, act=act, gain=gain,
                                               clamp=clamp),
                     jnp.asarray(x), jnp.asarray(b))
    want_dx, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    dx, db = _port_vjp(x, b, g, act, gain, clamp)
    np.testing.assert_allclose(dx, want_dx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(db, want_db, rtol=1e-5, atol=1e-4)


def test_bias_act_grad_mask_is_strict_at_the_clamp():
    """|y| == clamp passes no gradient (jnp.clip's own VJP passes half)."""
    # 181.01934814453125 * f32(sqrt 2) rounds to 256 exactly in f32;
    # -2000 saturates at -256; 1 is inside
    x = torch.tensor([181.01934814453125, -2000.0, 1.0]).reshape(1, 3, 1)
    b = torch.zeros(3)
    y = bias_act(x, b, "lrelu", 1.0, 256.0)
    assert y[0, 0, 0] == 256.0
    dx = bias_act_grad_plain(torch.ones(1, 3, 1), x, b, 0.2, math.sqrt(2),
                             256.0)
    assert dx[0, 0, 0] == 0 and dx[0, 1, 0] == 0
    assert dx[0, 2, 0] == pytest.approx(math.sqrt(2))


@pytest.mark.parametrize("act,clamp", [("lrelu", 256.0), ("lrelu", None),
                                       ("linear", 3.0)])
def test_bias_act_gradcheck_f64(act, clamp):
    torch.manual_seed(0)
    scale = 200.0 if clamp == 256.0 else 2.0
    x = (torch.randn(2, 4, 3, 5, dtype=torch.float64) * scale
         ).requires_grad_()
    b = torch.randn(4, dtype=torch.float64).requires_grad_()

    def f(x, b):
        return bias_act(x, b, act, 1.0, clamp)

    assert torch.autograd.gradcheck(f, (x, b))
    assert torch.autograd.gradgradcheck(f, (x, b))


def test_bias_act_double_backward_is_the_grad_kernel():
    """d(dx)/dg applied to gg is B1b(gg): what stage 1's R1 penalty
    needs."""
    torch.manual_seed(1)
    x = (torch.randn(2, 4, 3, 3) * 200).requires_grad_()
    b = torch.randn(4)
    g = torch.randn(2, 4, 3, 3).requires_grad_()
    gg = torch.randn(2, 4, 3, 3)
    y = bias_act(x, b, "lrelu", 1.0, 256.0)
    (dx,) = torch.autograd.grad(y, x, g, create_graph=True)
    (ddg,) = torch.autograd.grad(dx, g, gg)
    want = bias_act_grad(gg, x.detach(), b, 0.2, math.sqrt(2), 256.0)
    torch.testing.assert_close(ddg, want, rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 4), (4, 7), (7, 2)])
@pytest.mark.parametrize("c", [3, 8])
def test_smooth_upsample_grad_matches_jax_vjp(h, w, c):
    rng = np.random.RandomState(h * 10 + w + c)
    x = rng.randn(2, h, w, c).astype(np.float32)
    g = rng.randn(2, 2 * h, 2 * w, c).astype(np.float32)
    _, vjp = jax.vjp(jresample.smooth_upsample, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = nchw(x).requires_grad_()
    (got,) = torch.autograd.grad(smooth_upsample(xt), xt, nchw(g))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nhwc(smooth_upsample_grad(nchw(g))),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 1, 1), (1, 1, 4, 7), (1, 1, 7, 2)])
def test_smooth_upsample_gradcheck_f64(shape):
    torch.manual_seed(2)
    x = torch.randn(shape, dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(smooth_upsample, (x,))
    assert torch.autograd.gradgradcheck(smooth_upsample, (x,))


def _kernel_axis_weights(n):
    """The (2n, n) matrix A[m, j] of one axis of B2's taps, clamped at the
    edges: the weights kernel B2b's header (``csrc/smooth_upsample_grad.cu``)
    states, [1, 4, 6, 4, 1] / 8 inside and the edge terms at j = 0, n - 1."""
    k = (0.125, 0.375, 0.375, 0.125)
    a = np.zeros((2 * n, n))
    for j in range(n):
        for q in range(5):
            m = 2 * j - 1 + q
            if 0 <= m < 2 * n:
                a[m, j] = sum(k[t] for t in range(4)
                              if min(max(m + t - 2, 0), 2 * n - 1) // 2 == j)
    return a


@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (4, 7), (8, 8)])
def test_b2b_weight_rule_is_the_adjoint(h, w):
    """B2b's 5x5 gather weights (the product of two axes' A) equal the
    plain adjoint, edge terms included; interior columns sum to 2, the
    first to 2.5 and the last to 1.5."""
    g = torch.randn(2, 3, 2 * h, 2 * w, dtype=torch.float64)
    ay = torch.from_numpy(_kernel_axis_weights(h))
    ax = torch.from_numpy(_kernel_axis_weights(w))
    want = torch.einsum("mi,nj,bcmn->bcij", ay, ax, g)
    torch.testing.assert_close(smooth_upsample_grad_plain(g), want,
                               rtol=1e-12, atol=1e-12)
    sums = _kernel_axis_weights(7).sum(axis=0)
    np.testing.assert_array_equal(sums, [2.5, 2, 2, 2, 2, 2, 1.5])


@pytest.mark.parametrize("op", ["bias_act_grad", "smooth_upsample_grad"])
def test_non_cpu_tensor_never_takes_the_plain_grad(op):
    g = torch.empty(2, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "bias_act_grad":
            bias_act_grad(g, g, torch.empty(4, device="meta"), 0.2, 1.0,
                          None)
        else:
            smooth_upsample_grad(g)
    assert bias_act_grad.launches == 0 and smooth_upsample_grad.launches == 0
