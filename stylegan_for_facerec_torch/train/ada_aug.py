"""Adaptive discriminator augmentation (ADA), NCHW: the pipeline of
``stylegan_for_facerec_tpu/train/ada_aug.py``, each group gated per image
with probability p:

  blit      x-flip, 90-degree rotations, integer translation
  geom      isotropic scale, rotation, anisotropic scale, rotation,
            fractional translation: one affine map per image, one bilinear
            warp (``F.grid_sample``, zeros outside)
  color     brightness, contrast, luma flip, hue rotation, saturation: one
            4x4 color matrix per image
  filter    four dyadic bands of separable binomial blurs, lognormal gains
  corrupt   additive RGB noise, cutout

All randomness is drawn by ``sample_ada_params`` (and the ``sample_*`` of
each group) from one ``torch.Generator`` as tensors with a leading batch
dimension; ``apply_ada`` (and each ``apply_*``) is deterministic, so a
test can feed it the JAX package's draws. Images a group leaves alone come
out bit for bit as they went in, and every ``apply_*`` is differentiable
with respect to x (the G step augments fakes). The transforms run in f32
outside autocast and return x's dtype.
"""

from __future__ import annotations

import math
from typing import Dict, Union

import numpy as np
import torch
import torch.nn.functional as F

Prob = Union[float, torch.Tensor]
Params = Dict[str, torch.Tensor]


def _bernoulli(g: torch.Generator, p: Prob, n: int, device) -> torch.Tensor:
    return torch.rand(n, generator=g, device=device) < p


def _randn(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=device)


def _uniform(g: torch.Generator, n: int, lo: float, hi: float, device):
    return torch.rand(n, generator=g, device=device) * (hi - lo) + lo


def _gate(active: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    return torch.where(active[:, None, None, None], y, x)


# -- pixel blitting -----------------------------------------------------------

def _max_shift(h: int) -> int:
    return max(1, int(0.125 * h))


def sample_blit(g: torch.Generator, n: int, h: int, p: Prob,
                device=None) -> Params:
    """The x-flip fires on half of its draws, rot90's k = 0 is a draw too:
    identity is a valid outcome, as in the stylegan2-ada policy."""
    m = _max_shift(h)
    flip = _bernoulli(g, p, n, device)
    do_rot = _bernoulli(g, p, n, device)
    k = torch.randint(0, 4, (n,), generator=g, device=device)
    do_t = _bernoulli(g, p, n, device)
    ty = torch.randint(-m, m + 1, (n,), generator=g, device=device)
    tx = torch.randint(-m, m + 1, (n,), generator=g, device=device)
    flip = flip & _bernoulli(g, 0.5, n, device)
    zero = torch.zeros_like(k)
    return {"flip": flip, "rotk": torch.where(do_rot, k, zero),
            "ty": torch.where(do_t, ty, zero),
            "tx": torch.where(do_t, tx, zero)}


def apply_blit(x: torch.Tensor, prm: Params) -> torch.Tensor:
    x = _gate(prm["flip"], x.flip(3), x)
    k = prm["rotk"][:, None, None, None]
    x = torch.where(k == 1, torch.rot90(x, 1, (2, 3)),
                    torch.where(k == 2, torch.rot90(x, 2, (2, 3)),
                                torch.where(k == 3, torch.rot90(x, 3, (2, 3)),
                                            x)))
    n, _, h, w = x.shape
    m = _max_shift(h)
    padded = F.pad(x, (m, m, m, m))
    rows = torch.arange(h, device=x.device)[None] + m + prm["ty"][:, None]
    cols = torch.arange(w, device=x.device)[None] + m + prm["tx"][:, None]
    idx = torch.arange(n, device=x.device)[:, None, None]
    # (N, H, W, C): the advanced indices go first
    out = padded[idx, :, rows[:, :, None], cols[:, None, :]]
    return out.permute(0, 3, 1, 2).contiguous()


# -- general geometric: one affine warp per image -----------------------------

def _rot2(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1),
                        torch.stack([s, c], -1)], -2)


def _diag2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([a, z], -1),
                        torch.stack([z, b], -1)], -2)


def sample_geom(g: torch.Generator, n: int, h: int, w: int, p: Prob,
                device=None) -> Params:
    """The inverse of T R2 S_ani R1 S_iso acting on centred (y, x);
    rotations fire with 1 - sqrt(1 - p)."""
    p_rot = 1.0 - torch.sqrt(torch.clamp(1.0 - torch.as_tensor(
        p, dtype=torch.float32, device=device), 0.0, 1.0))
    one = torch.ones(n, device=device)
    do_iso = _bernoulli(g, p, n, device)
    s_iso = torch.where(do_iso, torch.exp2(_randn(g, n, device) * 0.2), one)
    do_r1 = _bernoulli(g, p_rot, n, device)
    th1 = torch.where(do_r1, _uniform(g, n, -math.pi, math.pi, device),
                      0 * one)
    do_ani = _bernoulli(g, p, n, device)
    s_ani = torch.where(do_ani, torch.exp2(_randn(g, n, device) * 0.2), one)
    do_r2 = _bernoulli(g, p_rot, n, device)
    th2 = torch.where(do_r2, _uniform(g, n, -math.pi, math.pi, device),
                      0 * one)
    do_t = _bernoulli(g, p, n, device)
    t = torch.where(do_t[:, None], _randn(g, (n, 2), device) * 0.125,
                    0 * one[:, None])
    t = t * torch.tensor([h, w], dtype=torch.float32, device=device)
    lin_inv = (_diag2(1.0 / s_iso, 1.0 / s_iso) @ _rot2(-th1)
               @ _diag2(1.0 / s_ani, s_ani) @ _rot2(-th2))
    return {"lin_inv": lin_inv, "t": t,
            "active": do_iso | do_r1 | do_ani | do_r2 | do_t}


def apply_geom(x: torch.Tensor, prm: Params) -> torch.Tensor:
    """Output pixel (y, x) samples the input at ``lin_inv ((y, x) - c - t)
    + c`` (pixel centres, c the image centre), bilinear, zeros outside."""
    n, _, h, w = x.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x.device) - cy
    xs = torch.arange(w, dtype=torch.float32, device=x.device) - cx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dst = torch.stack([gy, gx], 0).reshape(2, -1)                # (2, HW)
    src = prm["lin_inv"].float() @ (dst[None] - prm["t"].float()[:, :, None])
    # pixel coordinates (y, x) -> grid_sample's (x, y) in [-1, 1] at the
    # first and last pixel centres (align_corners)
    sy = (src[:, 0] + cy) * (2.0 / max(h - 1, 1)) - 1.0
    sx = (src[:, 1] + cx) * (2.0 / max(w - 1, 1)) - 1.0
    grid = torch.stack([sx, sy], -1).reshape(n, h, w, 2)
    warped = F.grid_sample(x.float(), grid, mode="bilinear",
                           padding_mode="zeros", align_corners=True)
    return _gate(prm["active"], warped.to(x.dtype), x)


# -- color: one 4x4 color matrix per image ------------------------------------

_LUMA = np.asarray([1.0, 1.0, 1.0]) / np.sqrt(3.0)


def sample_color(g: torch.Generator, n: int, p: Prob, device=None) -> Params:
    """brightness -> contrast -> luma flip -> hue rotation -> saturation,
    composed into one (N, 4, 4) matrix."""
    f32 = dict(dtype=torch.float32, device=device)
    eye4 = torch.eye(4, **f32).expand(n, 4, 4)
    eye3 = torch.eye(3, **f32)
    v = torch.tensor(_LUMA, **f32)
    vv = torch.outer(v, v)
    one = torch.ones(n, device=device)

    def with_block(block):                          # (N, 3, 3) into eye4
        m = eye4.clone()
        m[:, :3, :3] = block
        return m

    do_b = _bernoulli(g, p, n, device)
    b = torch.where(do_b, _randn(g, n, device) * 0.2, 0 * one)
    m = eye4.clone()
    m[:, :3, 3] = b[:, None]

    do_c = _bernoulli(g, p, n, device)
    c = torch.where(do_c, torch.exp2(_randn(g, n, device) * 0.5), one)
    mc = eye4.clone()
    mc[:, :3, :3] = eye3 * c[:, None, None]
    m = mc @ m

    do_f = _bernoulli(g, p, n, device)
    flip = eye3 - 2.0 * vv
    m = with_block(torch.where(do_f[:, None, None], flip, eye3)) @ m

    do_h = _bernoulli(g, p, n, device)
    th = torch.where(do_h, _uniform(g, n, -math.pi, math.pi, device), 0 * one)
    cth, sth = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    vx = torch.tensor([[0, -_LUMA[2], _LUMA[1]], [_LUMA[2], 0, -_LUMA[0]],
                       [-_LUMA[1], _LUMA[0], 0]], **f32)
    m = with_block(cth * eye3 + sth * vx + (1 - cth) * vv) @ m   # Rodrigues

    do_s = _bernoulli(g, p, n, device)
    s = torch.where(do_s, torch.exp2(_randn(g, n, device)), one)
    m = with_block(vv + (eye3 - vv) * s[:, None, None]) @ m
    return {"m": m, "active": do_b | do_c | do_f | do_h | do_s}


def apply_color(x: torch.Tensor, prm: Params) -> torch.Tensor:
    m = prm["m"].float()
    y = torch.einsum("nij,njhw->nihw", m[:, :3, :3], x.float()) \
        + m[:, :3, 3, None, None]
    return _gate(prm["active"], y.to(x.dtype), x)


# -- image-space filtering: four dyadic bands ---------------------------------

_K_BINOMIAL = (0.25, 0.5, 0.25)


def _sep_blur(x: torch.Tensor, times: int = 1) -> torch.Tensor:
    """The [1, 2, 1] / 4 blur on both axes, ``times`` times, depthwise,
    zero padding, same size."""
    c = x.shape[1]
    k = torch.tensor(_K_BINOMIAL, dtype=x.dtype, device=x.device)
    kv = k.reshape(1, 1, 3, 1).expand(c, 1, 3, 1)
    kh = k.reshape(1, 1, 1, 3).expand(c, 1, 1, 3)
    for _ in range(times):
        x = F.conv2d(x, kv, padding=(1, 0), groups=c)
        x = F.conv2d(x, kh, padding=(0, 1), groups=c)
    return x


def sample_filter(g: torch.Generator, n: int, p: Prob, device=None) -> Params:
    """Per-band gains 2^N(0, 1), normalised to unit mean square."""
    gains, dos = [], []
    for _ in range(4):
        do = _bernoulli(g, p, n, device)
        gains.append(torch.where(do, torch.exp2(_randn(g, n, device)),
                                 torch.ones(n, device=device)))
        dos.append(do)
    gain = torch.stack(gains, -1)
    gain = gain / torch.sqrt(gain.square().mean(-1, keepdim=True))
    return {"g": gain, "active": dos[0] | dos[1] | dos[2] | dos[3]}


def apply_filter(x: torch.Tensor, prm: Params) -> torch.Tensor:
    xf = x.float()
    lp1 = _sep_blur(xf, 1)
    lp2 = _sep_blur(lp1, 2)
    lp3 = _sep_blur(lp2, 4)
    bands = [xf - lp1, lp1 - lp2, lp2 - lp3, lp3]       # high -> low
    gain = prm["g"].float()
    y = sum(b * gain[:, i, None, None, None] for i, b in enumerate(bands))
    return _gate(prm["active"], y.to(x.dtype), x)


# -- corruptions: additive noise, cutout --------------------------------------

def sample_corrupt(g: torch.Generator, n: int, c: int, h: int, w: int,
                   p: Prob, device=None) -> Params:
    do_n = _bernoulli(g, p, n, device)
    sigma = _randn(g, n, device).abs() * 0.1
    noise = _randn(g, (n, c, h, w), device) \
        * torch.where(do_n, sigma, 0 * sigma)[:, None, None, None]
    return {"noise": noise, "do_noise": do_n,
            "cut": _bernoulli(g, p, n, device),
            "center": torch.rand((n, 2), generator=g, device=device)}


def apply_corrupt(x: torch.Tensor, prm: Params) -> torch.Tensor:
    n, _, h, w = x.shape
    x = _gate(prm["do_noise"], x + prm["noise"].to(x.dtype), x)
    cy = prm["center"][:, 0].float() * h
    cx = prm["center"][:, 1].float() * w
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    mask = ((ys - cy[:, None, None]).abs() < h * 0.25) \
        & ((xs - cx[:, None, None]).abs() < w * 0.25) \
        & prm["cut"][:, None, None]
    return torch.where(mask[:, None], torch.zeros_like(x), x)


# -- pipeline -----------------------------------------------------------------

def sample_ada_params(g: torch.Generator, n: int, c: int, h: int, w: int,
                      p: Prob, device=None) -> Dict[str, Params]:
    """Every draw of the pipeline for n images of (c, h, w), on ``device``
    (the generator's)."""
    return {"blit": sample_blit(g, n, h, p, device),
            "geom": sample_geom(g, n, h, w, p, device),
            "color": sample_color(g, n, p, device),
            "filter": sample_filter(g, n, p, device),
            "corrupt": sample_corrupt(g, n, c, h, w, p, device)}


def apply_ada(x: torch.Tensor, prm: Dict[str, Params]) -> torch.Tensor:
    with torch.autocast(x.device.type, enabled=False):
        x = apply_blit(x, prm["blit"])
        x = apply_geom(x, prm["geom"])
        x = apply_color(x, prm["color"])
        x = apply_filter(x, prm["filter"])
        return apply_corrupt(x, prm["corrupt"])


def ada_augment(g: torch.Generator, x: torch.Tensor, p: Prob) -> torch.Tensor:
    """The whole pipeline, every group gated per image with probability p."""
    n, c, h, w = x.shape
    return apply_ada(x, sample_ada_params(g, n, c, h, w, p, x.device))


def _single_group(sample, apply, dims):
    def fn(g: torch.Generator, x: torch.Tensor, p: Prob) -> torch.Tensor:
        n, c, h, w = x.shape
        args = {"n": (n,), "nh": (n, h), "nhw": (n, h, w),
                "nchw": (n, c, h, w)}[dims]
        with torch.autocast(x.device.type, enabled=False):
            return apply(x, sample(g, *args, p, x.device))
    return fn


blit_augment = _single_group(sample_blit, apply_blit, "nh")
geom_augment = _single_group(sample_geom, apply_geom, "nhw")
color_augment = _single_group(sample_color, apply_color, "n")
filter_augment = _single_group(sample_filter, apply_filter, "n")
corrupt_augment = _single_group(sample_corrupt, apply_corrupt, "nchw")

AUG_GROUPS = (("blit", blit_augment), ("geom", geom_augment),
              ("color", color_augment), ("filter", filter_augment),
              ("corrupt", corrupt_augment))
