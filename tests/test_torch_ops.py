"""The port's ops against the JAX package's, on the CPU (plain versions).

Layouts: the JAX ops are NHWC, the port's NCHW; inputs come from numpy and
are transposed for the port. Tolerances: 1e-6 for B1's plain version (the
same f32 operations in the same order), 1e-5 for B2's (the blur sums taps
in another order than upfirdn / the Pallas polyphase), 1e-5 for the
modulated conv and resize (matmul/conv sum order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.ops import fused_act as jfa
from stylegan_for_facerec_tpu.ops import image as jimage
from stylegan_for_facerec_tpu.ops import modconv as jmodconv
from stylegan_for_facerec_tpu.ops import resample as jresample
from stylegan_for_facerec_tpu.ops.upfirdn_pallas import smooth_upsample_pallas
from stylegan_for_facerec_torch.ops import (bias_act, bias_act_plain,
                                            modulated_conv2d, resize_bilinear,
                                            smooth_upsample,
                                            smooth_upsample_plain)
from stylegan_for_facerec_torch.ops import build


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


@pytest.mark.parametrize("act,gain,clamp", [("lrelu", 1.0, 256.0),
                                            ("lrelu", 0.5, None),
                                            ("linear", 2.0, 1.0)])
def test_bias_act_matches_jax(act, gain, clamp):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 6, 8) * 200).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    want = np.asarray(jfa.bias_act(jnp.asarray(x), jnp.asarray(b), act=act,
                                   gain=gain, clamp=clamp))
    for fn in (bias_act_plain, bias_act):   # bias_act on a CPU tensor
        got = nhwc(fn(nchw(x), torch.from_numpy(b), act, gain, clamp))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("clamp", [None, 256.0])
def test_bias_act_matches_pallas_kernel(clamp):
    """Against fused_bias_act_pallas run in interpret mode (C = 128)."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 4, 4, 128) * 300).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    want = np.asarray(jfa.fused_bias_act_pallas(
        jnp.asarray(x), jnp.asarray(b), 0.2, math.sqrt(2), clamp))
    got = nhwc(bias_act_plain(nchw(x), torch.from_numpy(b), "lrelu", 1.0,
                              clamp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 8, 8, 5), (2, 4, 4, 3), (1, 1, 1, 3),
                                   (2, 6, 10, 4)])
def test_smooth_upsample_matches_jax(shape):
    """Includes C = 3 (the image skip) and 4x4 (the first block)."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = np.asarray(jresample.smooth_upsample(jnp.asarray(x)))
    for fn in (smooth_upsample_plain, smooth_upsample):
        got = nhwc(fn(nchw(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,tile_h", [((2, 16, 8, 3), 8),
                                          ((1, 32, 16, 5), 4),
                                          ((1, 8, 8, 2), 8)])
def test_smooth_upsample_matches_pallas_kernel(shape, tile_h):
    """Against smooth_upsample_pallas in interpret mode."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    want = np.asarray(smooth_upsample_pallas(jnp.asarray(x), tile_h=tile_h))
    got = nhwc(smooth_upsample_plain(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("demodulate,k", [(True, 3), (False, 1)])
def test_modulated_conv2d_matches_jax(demodulate, k):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 8, 8, 16).astype(np.float32)
    w = (rng.randn(k, k, 16, 12) * 0.2).astype(np.float32)
    s = (rng.rand(3, 16) + 0.5).astype(np.float32)
    want = np.asarray(jmodconv.modulated_conv2d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(s), padding=k // 2,
        demodulate=demodulate))
    got = modulated_conv2d(nchw(x), torch.from_numpy(
        np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))),
        torch.from_numpy(s), padding=k // 2, demodulate=demodulate)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [((32, 32), (112, 112)),
                                     ((256, 256), (112, 112)),
                                     ((20, 12), (7, 30)), ((9, 9), (9, 9))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(5).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), *dst))
    got = nhwc(resize_bilinear(nchw(x), *dst))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["bias_act", "smooth_upsample"])
def test_non_cpu_tensor_never_takes_the_plain_version(op):
    """A tensor off the CPU goes to the kernel's checks, which refuse what
    is not a CUDA tensor, instead of falling back to the plain version."""
    x = torch.empty(2, 4, 8, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if op == "bias_act":
            bias_act(x, torch.empty(4, device="meta"))
        else:
            smooth_upsample(x)
    assert bias_act.launches == 0 and smooth_upsample.launches == 0


def test_kernel_sources_hash_into_library_names():
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
