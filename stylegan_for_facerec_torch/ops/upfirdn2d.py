"""upfirdn2d: zero-insert upsample, pad or crop, FIR filter, downsample.
NCHW. The semantics of ``stylegan_for_facerec_tpu/ops/upfirdn2d.py``:

    1. insert up - 1 zeros after each sample (both axes),
    2. pad by (pad0, pad1) per axis; negative pads crop,
    3. convolve with the kernel (a true convolution: the kernel flipped),
    4. keep every ``down``-th sample.

``upfirdn2d`` runs steps 1-2 as ``F.pad`` and steps 3-4 as depthwise
``F.conv2d`` (``groups=C``) with stride ``down``, split into a vertical and
a horizontal pass when the kernel is rank 1 (every StyleGAN blur kernel
is a binomial outer product). The JAX package computes this with
``lax.conv`` outside any Pallas kernel; here it is PyTorch's convolution.
It is differentiable to any order (the discriminator's R1 penalty
differentiates its ``Blur`` twice) through a pair of autograd Functions:
the depthwise correlation, whose backward is the transposed correlation,
whose backward is the correlation again. PyTorch's own double backward of
a grouped convolution would take the weight's gradient one group at a
time: C convolutions per blur. ``upfirdn2d_ref`` is the literal sequence,
kept as the test oracle.

Pads follow the reference: a 2-tuple pads both axes by (pad0, pad1); a
4-tuple is (x0, x1, y0, y1).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Pair = Union[int, Sequence[int]]


def _as_pair(v: Pair) -> Tuple[int, int]:
    """(x, y) factors from an int or a 2-sequence in (x, y) order."""
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _pads(pad: Sequence[int]) -> Tuple[int, int, int, int]:
    if len(pad) == 2:
        return pad[0], pad[1], pad[0], pad[1]
    if len(pad) == 4:
        return tuple(pad)   # (x0, x1, y0, y1)
    raise ValueError(f"pad must have 2 or 4 entries, got {pad}")


def _separable_factors(kernel: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(col, row) with ``kernel == outer(col, row)`` when the 2-D kernel is
    rank 1 to round-off, else None."""
    if kernel.ndim != 2:
        return None
    u, s, vt = np.linalg.svd(kernel.astype(np.float64))
    if s.size > 1 and s[1] > 1e-10 * max(s[0], 1e-30):
        return None
    col = u[:, 0] * np.sqrt(s[0])
    row = vt[0, :] * np.sqrt(s[0])
    if col.sum() < 0:
        col, row = -col, -row
    return col, row


def make_resample_kernel(k) -> np.ndarray:
    """A 1-D kernel as its outer product with itself, normalised to sum 1
    (a 2-D kernel is only normalised)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    return k / k.sum()


def _zero_insert_pad(x: torch.Tensor, up_x: int, up_y: int,
                     pad: Tuple[int, int, int, int]) -> torch.Tensor:
    n, c, h, w = x.shape
    if up_x > 1 or up_y > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, (0, up_x - 1, 0, 0, 0, up_y - 1))
        x = x.reshape(n, c, h * up_y, w * up_x)
    x0, x1, y0, y1 = pad
    if any(pad):
        x = F.pad(x, (x0, x1, y0, y1))      # negative entries crop
    return x


@functools.lru_cache(maxsize=64)
def _taps_tensor(data: bytes, shape: Tuple[int, int], device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """The taps on the device, made once: a copy from the host per call
    would wait for the stream."""
    taps = np.frombuffer(data, dtype=np.float32).reshape(shape)
    return torch.tensor(taps, dtype=dtype, device=device)


class _Depthwise(torch.autograd.Function):
    """y = every channel of x correlated with the taps w (1, 1, kh, kw) at
    ``stride``; no gradient for the taps."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(w)
        ctx.stride, ctx.in_hw = stride, tuple(x.shape[2:])
        c = x.shape[1]
        return F.conv2d(x, w.to(x.dtype).expand(c, -1, -1, -1),
                        stride=stride, groups=c)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _DepthwiseT.apply(g, w, ctx.stride, ctx.in_hw), None, None


class _DepthwiseT(torch.autograd.Function):
    """The adjoint of ``_Depthwise`` back to the input size ``in_hw``; its
    own backward is ``_Depthwise``."""

    @staticmethod
    def forward(ctx, g, w, stride, in_hw):
        ctx.save_for_backward(w)
        ctx.stride = stride
        kh, kw = w.shape[2:]
        extra = (in_hw[0] - ((g.shape[2] - 1) * stride[0] + kh),
                 in_hw[1] - ((g.shape[3] - 1) * stride[1] + kw))
        c = g.shape[1]
        return F.conv_transpose2d(g, w.to(g.dtype).expand(c, -1, -1, -1),
                                  stride=stride, output_padding=extra,
                                  groups=c)

    @staticmethod
    def backward(ctx, gg):
        (w,) = ctx.saved_tensors
        return _Depthwise.apply(gg, w, ctx.stride), None, None, None


def _depthwise(x: torch.Tensor, taps: np.ndarray, stride) -> torch.Tensor:
    """Correlation of every channel with the 2-D ``taps``."""
    taps = np.ascontiguousarray(taps, dtype=np.float32)
    w = _taps_tensor(taps.tobytes(), taps.shape, x.device, x.dtype)
    return _Depthwise.apply(x, w[None, None], tuple(stride) if not
                            isinstance(stride, int) else (stride, stride))


@functools.lru_cache(maxsize=64)
def _passes(data: bytes, shape: Tuple[int, int]):
    """The flipped kernel as (column (kh, 1), row (1, kw)) passes when it
    is rank 1 and both sides exceed 1, else as one 2-D pass."""
    flipped = np.frombuffer(data, dtype=np.float32).reshape(shape)[::-1, ::-1]
    sep = _separable_factors(flipped)
    if sep is not None and min(shape) > 1:
        col, row = sep
        return (col.astype(np.float32)[:, None],
                row.astype(np.float32)[None, :])
    return (np.ascontiguousarray(flipped),)


def upfirdn2d(x: torch.Tensor, kernel, up: Pair = 1, down: Pair = 1,
              pad: Sequence[int] = (0, 0)) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, H', W') with
    H' = (H * up_y + pad_y0 + pad_y1 - kh) // down_y + 1 (W' alike);
    ``up`` and ``down`` are an int or (x, y)."""
    up_x, up_y = _as_pair(up)
    down_x, down_y = _as_pair(down)
    kernel = np.ascontiguousarray(kernel, dtype=np.float32)
    x = _zero_insert_pad(x, up_x, up_y, _pads(pad))
    passes = _passes(kernel.tobytes(), kernel.shape)
    if len(passes) == 2:
        x = _depthwise(x, passes[0], (down_y, 1))
        return _depthwise(x, passes[1], (1, down_x))
    return _depthwise(x, passes[0], (down_y, down_x))


def upfirdn2d_ref(x: torch.Tensor, kernel, up: Pair = 1, down: Pair = 1,
                  pad: Sequence[int] = (0, 0)) -> torch.Tensor:
    """The literal sequence, one step at a time: the test oracle."""
    up_x, up_y = _as_pair(up)
    down_x, down_y = _as_pair(down)
    x0, x1, y0, y1 = _pads(pad)
    n, c, h, w = x.shape
    out = x.new_zeros((n, c, h * up_y, w * up_x))
    out[:, :, ::up_y, ::up_x] = x
    out = F.pad(out, (max(x0, 0), max(x1, 0), max(y0, 0), max(y1, 0)))
    out = out[:, :, max(-y0, 0): out.shape[2] - max(-y1, 0),
              max(-x0, 0): out.shape[3] - max(-x1, 0)]
    k = np.asarray(kernel, dtype=np.float32)[::-1, ::-1]
    out = _depthwise(out, k, 1)
    return out[:, :, ::down_y, ::down_x]
