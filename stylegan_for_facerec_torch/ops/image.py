"""Image primitives, as ``stylegan_for_facerec_tpu/ops/image.py``.

``resize_bilinear`` works on NCHW: half-pixel centres, no anti-aliasing,
the semantics of ``F.interpolate(mode='bilinear', align_corners=False)``
but computed with the same interpolation matrices as the JAX package, so
that the two agree to float rounding rather than to ~1e-4;
``resize_bilinear_align_corners`` likewise for align_corners=True. The
verification TTA and the stage-3 augmentations take NHWC batches in
[-1, 1]. Each random augmentation is a draw from an explicit
``torch.Generator`` (``draw_crop_offsets``, ``draw_flips``) and a
deterministic function of what was drawn (``crop_at``, ``flip_at``).
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
    return _resize_with(x, _interp_matrix(h, out_h), _interp_matrix(w, out_w))


@functools.lru_cache(maxsize=64)
def _interp_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) matrix of the align_corners=True resize:
    src = o * (in - 1) / (out - 1)."""
    m = np.zeros((in_size, out_size), dtype=np.float32)
    scale = (in_size - 1) / max(out_size - 1, 1)
    for o in range(out_size):
        src = o * scale
        lo = int(np.floor(src))
        frac = src - lo
        hi = min(lo + 1, in_size - 1)
        m[lo, o] += 1.0 - frac
        m[hi, o] += frac
    m.setflags(write=False)
    return m


def _resize_with(x: torch.Tensor, mh: np.ndarray,
                 mw: np.ndarray) -> torch.Tensor:
    mh = torch.as_tensor(mh.copy(), dtype=x.dtype, device=x.device)
    mw = torch.as_tensor(mw.copy(), dtype=x.dtype, device=x.device)
    return torch.matmul(torch.matmul(mh.t(), x), mw)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, out_h, out_w), the semantics of
    ``nn.UpsamplingBilinear2d`` (align_corners=True), with the JAX
    package's interpolation matrices."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    return _resize_with(x, _interp_matrix_align_corners(h, out_h),
                        _interp_matrix_align_corners(w, out_w))


def hflip(x: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of an NHWC batch."""
    return x.flip(2)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[:, top:top + size, left:left + size, :]


def quantize_uint8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 -> [-1, 1] as torchvision's ToPILImage/ToTensor
    round trip: ``mul(255).byte()`` truncates, so this floors (values out
    of range clip)."""
    x01 = torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
    q = torch.floor(x01 * 255.0)
    return (q / 255.0 - 0.5) / 0.5


def ccrop_tta(x: torch.Tensor, resize_to: int = 128, crop: int = 112,
              quantize: bool = True) -> torch.Tensor:
    """The evaluation's centre-crop TTA on NHWC: resize to ``resize_to``
    square, centre-crop ``crop``, each side of it optionally through the
    uint8 round trip."""
    if quantize:
        x = quantize_uint8_roundtrip(x)
    y = resize_bilinear(x.permute(0, 3, 1, 2), resize_to, resize_to)
    y = center_crop(y.permute(0, 2, 3, 1), crop)
    if quantize:
        y = quantize_uint8_roundtrip(y)
    return y


def normalize_pm1(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return (x01 - 0.5) / 0.5


def draw_crop_offsets(n: int, h: int, w: int, size: int,
                      generator: torch.Generator):
    """(tops, lefts): one uniform crop offset per image, on the
    generator's device."""
    dev = generator.device
    tops = torch.randint(0, h - size + 1, (n,), generator=generator,
                         device=dev)
    lefts = torch.randint(0, w - size + 1, (n,), generator=generator,
                          device=dev)
    return tops, lefts


def crop_at(x: torch.Tensor, tops: torch.Tensor, lefts: torch.Tensor,
            size: int) -> torch.Tensor:
    """Crop image i of the NHWC batch at (tops[i], lefts[i])."""
    ar = torch.arange(size, device=x.device)
    rows = (tops.to(x.device)[:, None] + ar)[:, :, None]
    cols = (lefts.to(x.device)[:, None] + ar)[:, None, :]
    idx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[idx, rows, cols]


def random_crop(x: torch.Tensor, size: int,
                generator: torch.Generator) -> torch.Tensor:
    n, h, w = x.shape[:3]
    return crop_at(x, *draw_crop_offsets(n, h, w, size, generator), size)


def draw_flips(n: int, generator: torch.Generator,
               p: float = 0.5) -> torch.Tensor:
    """(n,) bools, each True with probability p."""
    return torch.rand(n, generator=generator, device=generator.device) < p


def flip_at(x: torch.Tensor, flips: torch.Tensor) -> torch.Tensor:
    """Flip image i of the NHWC batch where flips[i]."""
    return torch.where(flips.to(x.device)[:, None, None, None], hflip(x), x)


def random_hflip(x: torch.Tensor, generator: torch.Generator,
                 p: float = 0.5) -> torch.Tensor:
    return flip_at(x, draw_flips(x.shape[0], generator, p))
