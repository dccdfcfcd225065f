"""The port's ``ops.upfirdn2d`` against the JAX package's ``upfirdn2d`` and
``upfirdn2d_ref`` on the CPU in f32 (tolerance 1e-5 of the output's
largest: depthwise convolutions summed in another order), and its first
and second derivatives by finite differences in f64 (the R1 penalty
differentiates the discriminator's blurs twice)."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the modules (each ops package also exports a function of this name)
jup = importlib.import_module("stylegan_for_facerec_tpu.ops.upfirdn2d")
tup = importlib.import_module("stylegan_for_facerec_torch.ops.upfirdn2d")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


K = [1, 3, 3, 1]
# (kernel, up, down, pad): the discriminator's blurs (pad (2, 1) and, for
# the 1x1 skip, (1, 1)), Downsample, Upsample's pad, upsampling by 2 and
# 4, negative pads that crop, a 4-tuple pad with an (x, y) factor pair,
# and a non-separable kernel
CASES = [
    (K, 1, 1, (2, 1)),
    (K, 1, 1, (1, 1)),
    (K, 1, 2, (1, 1)),
    (K, 2, 1, (2, 1)),
    (K, 2, 2, (1, 1)),
    ([1, 2, 1], 4, 1, (3, 2)),
    (K, 1, 1, (-1, 2)),
    (K, 2, 1, (1, -2)),
    (K, 1, 1, (2, 0, -1, 1)),
    (K, (2, 1), (1, 2), (0, 1, 2, -1)),
    (np.arange(9, dtype=np.float32).reshape(3, 3), 1, 1, (1, 1)),
]


def _kernel(k):
    k = np.asarray(k, np.float32)
    return tup.make_resample_kernel(k) if k.ndim == 1 else k


@pytest.mark.parametrize("case", range(len(CASES)))
def test_upfirdn2d_matches_jax(case):
    k, up, down, pad = CASES[case]
    kern = _kernel(k)
    x = np.random.RandomState(case).randn(2, 9, 11, 3).astype(np.float32)
    want = np.asarray(jup.upfirdn2d(jnp.asarray(x), kern, up=up, down=down,
                                    pad=pad))
    want_ref = np.asarray(jup.upfirdn2d_ref(jnp.asarray(x), kern, up=up,
                                            down=down, pad=pad))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tup.upfirdn2d(xt, kern, up=up, down=down, pad=pad)
    got_ref = tup.upfirdn2d_ref(xt, kern, up=up, down=down, pad=pad)
    scale = np.abs(want_ref).max()
    for name, g, w in (("upfirdn2d", got, want),
                       ("upfirdn2d_ref", got_ref, want_ref),
                       ("upfirdn2d vs JAX upfirdn2d_ref", got, want_ref)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("case", [0, 2, 4, 7, 9])
def test_upfirdn2d_twice_differentiable(case):
    k, up, down, pad = CASES[case]
    kern = _kernel(k)
    x = torch.randn((1, 2, 5, 6), generator=torch.Generator().manual_seed(
        case), dtype=torch.float64, requires_grad=True)

    def fn(t):
        return tup.upfirdn2d(t, kern, up=up, down=down, pad=pad)

    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))


def test_make_resample_kernel_matches_jax():
    for k in ([1, 3, 3, 1], [1, 2, 1], [[1, 2], [3, 4]]):
        np.testing.assert_array_equal(tup.make_resample_kernel(k),
                                      jup.make_resample_kernel(k))
