"""Fused bias + leaky ReLU + gain + clamp (the StyleGAN2-ADA activation).

``bias_act`` on a CUDA tensor launches kernel B1 (``csrc/bias_act.cu``),
which replaces the Pallas kernel ``_fba_kernel`` of
``stylegan_for_facerec_tpu/ops/fused_act.py::fused_bias_act_pallas``. On a
CPU tensor it runs ``bias_act_plain``, the same function in plain PyTorch.
B1 is bound by memory: it moves 2 * numel * elem bytes, one read of x and
one write of y, where the plain version makes four passes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build

_SQRT2 = math.sqrt(2.0)
_ACTS = {"lrelu": (0.2, _SQRT2), "linear": (1.0, 1.0)}  # slope, act gain


def bias_act_plain(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   act: str = "lrelu", gain: float = 1.0,
                   clamp: Optional[float] = None) -> torch.Tensor:
    """``clamp_gain(act(x + b), act_gain * gain, clamp * gain)``; x is
    (N, C, ...) with the bias over dim 1. Computed in x's dtype."""
    if act not in _ACTS:
        raise ValueError(act)
    if bias is not None:
        x = x + bias.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))
    slope, act_gain = _ACTS[act]
    if act == "lrelu":
        x = torch.where(x >= 0, x, slope * x)
    g = act_gain * gain
    if clamp is not None:
        return torch.clamp(x * g, -clamp * gain, clamp * gain)
    return x * g if g != 1.0 else x


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("bias_act").sgfr_fused_bias_act
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
             act: str = "lrelu", gain: float = 1.0,
             clamp: Optional[float] = None) -> torch.Tensor:
    """The semantics of ``bias_act_plain``; kernel B1 on a CUDA tensor
    (contiguous, f32 or bf16, math in f32), the plain version on a CPU one.
    ``bias_act.launches`` counts the kernel's launches."""
    if x.device.type == "cpu":
        return bias_act_plain(x, bias, act, gain, clamp)
    if act not in _ACTS:
        raise ValueError(act)
    if bias is None:
        bias = torch.zeros(x.shape[1], device=x.device)
    code = build.check_input("bias_act", x, bias)
    if x.dim() < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"bias_act: x {tuple(x.shape)} needs a bias of "
                         f"shape (C,) for C = dim 1, got {tuple(bias.shape)}")
    slope, act_gain = _ACTS[act]
    b = bias.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x)
    hw = math.prod(x.shape[2:])
    rc = _entry()(x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), hw,
                  x.shape[1], code, slope, act_gain * gain,
                  -1.0 if clamp is None else clamp * gain,
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error("bias_act", rc)
    bias_act.launches += 1
    return y


bias_act.launches = 0
