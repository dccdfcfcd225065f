"""Plain PyTorch operations the references share, and the arithmetic of
their lower-precision control.

``Precision("fp32")`` runs every convolution and matrix product as written.
``Precision("fp8")`` is the control a bf16 configuration is held against:
the operands of each convolution and matrix product are rounded to
float8 e4m3 with a per-tensor scale (amax / 448) in the forward pass and
the gradient reaching them to e5m2 (amax / 57344) in the backward pass,
as fp8 training rounds them; the products accumulate in float32 and
everything else stays float32.

``bias_act`` and ``smooth_upsample`` are the StyleGAN2-ADA activation and
2x upsample as written in the published code; ``tally``, where given, is a
list that receives ``(kernel, shape)`` for each call, which is how the
benchmark counts the bytes the port's B1 and B2 kernels must move.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
        "e5m2": (torch.float8_e5m2, 57344.0)}


def fp8_round(x: torch.Tensor, kind: str = "e4m3") -> torch.Tensor:
    """x rounded to float8 with a per-tensor scale, back in x's dtype."""
    dtype, top = _FP8[kind]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """e4m3 rounding in the forward pass, e5m2 rounding of the incoming
    gradient in the backward pass (straight through otherwise)."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, "e4m3")

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, "e5m2")


class Precision:
    """How a reference computes its convolutions and matrix products:
    "fp32" as written, "fp8" with fp8-rounded operands (the control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32|fp8")
        self.name = name

    def _q(self, t: Optional[torch.Tensor]):
        if t is None or self.name == "fp32" or t.device.type == "meta":
            return t
        return _Fp8.apply(t)

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self._q(x), self._q(w), b, stride=stride,
                        padding=padding)

    def linear(self, x, w, b=None):
        return F.linear(self._q(x), self._q(w), b)

    def matmul(self, a, b):
        return self._q(a) @ self._q(b)


def bias_act(x: torch.Tensor, b: Optional[torch.Tensor], act: str = "lrelu",
             gain: float = 1.0, clamp: Optional[float] = None,
             tally: Optional[List] = None) -> torch.Tensor:
    """StyleGAN2-ADA ``bias_act``: x + b over dim 1, leaky ReLU (slope 0.2,
    gain sqrt 2) or linear, times ``gain``, clamped to +-``clamp * gain``."""
    if tally is not None:
        tally.append(("bias_act", tuple(x.shape)))
    if b is not None:
        x = x + b.reshape((1, -1) + (1,) * (x.dim() - 2))
    g = gain
    if act == "lrelu":
        x = F.leaky_relu(x, 0.2)
        g = gain * math.sqrt(2.0)
    x = x * g
    if clamp is not None:
        x = x.clamp(-clamp * gain, clamp * gain)
    return x


def smooth_upsample(x: torch.Tensor,
                    tally: Optional[List] = None) -> torch.Tensor:
    """The synthesis network's smooth 2x upsample as this repository
    defines it (the JAX package's ``ops/resample.py::smooth_upsample``):
    nearest-neighbour 2x, edge replication (2 before, 1 after), then a
    [1, 3, 3, 1] / 8 blur on each axis. (N, C, H, W) -> (N, C, 2H, 2W)."""
    if tally is not None:
        tally.append(("smooth_upsample", tuple(x.shape)))
    c = x.shape[1]
    k = torch.tensor([1.0, 3.0, 3.0, 1.0], dtype=x.dtype,
                     device=x.device) / 8.0
    y = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    y = F.pad(y, (2, 1, 2, 1), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 4, 1).expand(c, 1, 4, 1), groups=c)
    return F.conv2d(y, k.view(1, 1, 1, 4).expand(c, 1, 1, 4), groups=c)


@contextlib.contextmanager
def no_tf32():
    """float32 products as float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
