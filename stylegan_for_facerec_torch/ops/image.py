"""Bilinear resize as two interpolation matmuls (NCHW).

Half-pixel centres, no anti-aliasing: the semantics of
``F.interpolate(mode='bilinear', align_corners=False)``, but computed with
the same interpolation matrices as the JAX package, so that the two agree
to float rounding rather than to ~1e-4.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) matrix M with out = M.T @ in."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    scale = in_size / out_size
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        lo = int(np.floor(src))
        frac = src - lo
        lo_c = min(max(lo, 0), in_size - 1)
        hi_c = min(max(lo + 1, 0), in_size - 1)
        m[lo_c, o] += 1.0 - frac
        m[hi_c, o] += frac
    m.setflags(write=False)
    return m


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, out_h, out_w)."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    mh = torch.as_tensor(_interp_matrix(h, out_h).copy(), dtype=x.dtype,
                         device=x.device)
    mw = torch.as_tensor(_interp_matrix(w, out_w).copy(), dtype=x.dtype,
                         device=x.device)
    return torch.matmul(torch.matmul(mh.t(), x), mw)
