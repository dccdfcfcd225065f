"""Fused bias + leaky ReLU + gain + clamp (the StyleGAN2-ADA activation),
and its gradient.

``bias_act`` runs the ``torch.library`` custom op ``sgfr::bias_act``. On a
CUDA tensor it launches kernel B1 (``csrc/bias_act.cu``), which replaces
the Pallas kernel ``_fba_kernel`` of
``stylegan_for_facerec_tpu/ops/fused_act.py::fused_bias_act_pallas``, and
its backward, the op ``sgfr::bias_act_grad``, launches kernel B1b
(``csrc/bias_act_grad.cu``), which replaces ``_fba_grad_kernel`` of that
op's custom VJP. On a CPU tensor the same ops run the plain versions,
``bias_act_plain`` and ``bias_act_grad_plain``. Each op has a fake
implementation, so ``torch.export`` traces them as graph nodes, and each
counts its launches inside its CUDA implementation, so an exported
program's launches count too. B1 moves 2 * numel * elem bytes (x read, y
written), B1b 3 * numel * elem (x and g read, dx written); both are bound
by memory.

The backward op is itself differentiable: its backward calls the grad
kernel on the incoming gradient: dx is linear in g and piecewise
constant in x, so that gives the second derivative (stage 1's R1 penalty
differentiates through B1 twice). The bias gradient ``db = sum(dx)`` is
taken in PyTorch, as the JAX package sums outside its kernel, and only
when the bias requires a gradient.

``fused_leaky_relu`` (the rosinality discriminator's activation) and
``clamp_gain`` are this op with other arguments: no separate path.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

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


def bias_act_grad_plain(g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
                        slope: float, gain: float,
                        clamp: Optional[float]) -> torch.Tensor:
    """The rule of the JAX grad kernel, with its total ``gain`` and
    ``clamp`` (the caller's already multiplied in):

        v = x + b;  y = (v >= 0 ? v : slope v) * gain
        dx = g * (v >= 0 ? gain : slope * gain) * [|y| < clamp]

    The mask is strict, as ``_fba_grad_kernel``'s: ``jnp.clip``'s own
    gradient would pass half at |y| == clamp. Computed in f32 (f64 for f64
    inputs), as B1b does, and returned in x's dtype."""
    ct = torch.promote_types(x.dtype, torch.float32)
    v = x.to(ct) + bias.to(ct).reshape((1, -1) + (1,) * (x.dim() - 2))
    pos = v >= 0
    d = torch.where(pos, v.new_full((), gain), v.new_full((), slope * gain))
    if clamp is not None:
        y = torch.where(pos, v, v * slope) * gain
        d = torch.where(y.abs() < clamp, d, 0.0)
    return (g.to(ct) * d).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("bias_act").sgfr_fused_bias_act
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_uint] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_uint] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grad_entry():
    fn = build.load("bias_act_grad").sgfr_fused_bias_act_grad
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_uint] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_bias(op: str, x: torch.Tensor, bias: torch.Tensor) -> int:
    code = build.check_input(op, x, bias)
    if x.dim() < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"{op}: x {tuple(x.shape)} needs a bias of shape "
                         f"(C,) for C = dim 1, got {tuple(bias.shape)}")
    return code


_THREADS, _UNROLL = 256, 4   # kThreads and kUnroll of bias_act(_grad).cu


@functools.lru_cache(maxsize=256)
def _plan(shape, elem: int, x_ptr: int, y_ptr: int, sms: int,
          g_ptr: int = 0) -> Tuple[int, ...]:
    """The launch of kernel B1 (x in, y out) or B1b (x and g in, dx = y
    out) for a contiguous x of ``shape`` read as (planes, hw) on a card of
    ``sms`` SMs: ``(vec, packed, per_block, blocks)`` and the (magic,
    shift) pairs of hw and C. The pointers count only modulo 16 (the
    wrapper passes them so, to hit the cache). 16-byte vectors (``vec = 16
    // elem`` values) only where every pointer is 16-byte aligned and hw is
    a multiple of vec, else the scalar path (vec 1). A chunk is
    ``_THREADS * vec * _UNROLL`` elements: a plane of at least one chunk is
    cut into chunks, one block each (packed 0, per_block = chunks per
    plane); smaller planes go whole to a block, up to a chunk's worth and
    no more than spreads them over the SMs (packed 1, per_block =
    planes per block)."""
    hw = math.prod(shape[2:])
    planes = math.prod(shape) // hw if hw else 0
    vec = 16 // elem
    if x_ptr % 16 or y_ptr % 16 or g_ptr % 16 or hw % vec:
        vec = 1
    chunk = _THREADS * vec * _UNROLL
    if hw >= chunk:
        per_block = -(-hw // chunk)
        packed, blocks = 0, planes * per_block
    else:
        per_block = max(1, min(chunk // hw, -(-planes // sms)))
        packed, blocks = 1, -(-planes // per_block)
    if planes >= 2 ** 31 or blocks >= 2 ** 31:
        raise ValueError(f"bias_act: {tuple(shape)} is too large for B1")
    return (vec, packed, per_block, blocks, *build.fastdiv(hw),
            *build.fastdiv(shape[1]))


@torch.library.custom_op("sgfr::bias_act", mutates_args=(),
                         device_types="cpu")
def _bias_act_op(x: torch.Tensor, bias: torch.Tensor, act: str, gain: float,
                 clamp: Optional[float]) -> torch.Tensor:
    """The op ``sgfr::bias_act``: its CPU implementation is the plain
    version; its CUDA implementation launches kernel B1."""
    return bias_act_plain(x, bias, act, gain, clamp)


@_bias_act_op.register_kernel("cuda")
def _bias_act_cuda(x, bias, act, gain, clamp):
    """Kernel B1 with the total gain and clamp."""
    slope, act_gain = _ACTS[act]
    code = _check_bias("bias_act", x, bias)
    b = bias.detach().to(torch.float32).contiguous()
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    hw = math.prod(x.shape[2:])
    plan = _plan(x.shape, x.element_size(), x.data_ptr() % 16,
                 y.data_ptr() % 16, build.sm_count(x.device.index))
    rc = _entry()(x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // hw,
                  hw, x.shape[1], code, *plan, slope, act_gain * gain,
                  -1.0 if clamp is None else clamp * gain,
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error("bias_act", rc)
    bias_act.launches += 1
    return y


@torch.library.custom_op("sgfr::bias_act_grad", mutates_args=(),
                         device_types="cpu")
def _bias_act_grad_op(g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
                      slope: float, gain: float,
                      clamp: Optional[float]) -> torch.Tensor:
    """The op ``sgfr::bias_act_grad``: its CPU implementation is the plain
    version; its CUDA implementation launches kernel B1b."""
    return bias_act_grad_plain(g, x, bias, slope, gain, clamp)


@_bias_act_grad_op.register_kernel("cuda")
def _bias_act_grad_cuda(g, x, bias, slope, gain, clamp):
    code = _check_bias("bias_act_grad", x, bias)
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"bias_act_grad: g {tuple(g.shape)} {g.dtype} "
                         f"{g.device} must be contiguous and match x "
                         f"{tuple(x.shape)} {x.dtype} {x.device}")
    b = bias.detach().to(torch.float32).contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    hw = math.prod(x.shape[2:])
    plan = _plan(x.shape, x.element_size(), x.data_ptr() % 16,
                 dx.data_ptr() % 16, build.sm_count(x.device.index),
                 g.data_ptr() % 16)
    rc = _grad_entry()(g.data_ptr(), x.data_ptr(), b.data_ptr(),
                       dx.data_ptr(), x.numel() // hw, hw, x.shape[1], code,
                       *plan, slope, gain, slope * gain,
                       -1.0 if clamp is None else clamp,
                       torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error("bias_act_grad", rc)
    bias_act_grad.launches += 1
    return dx


@_bias_act_op.register_fake
def _bias_act_fake(x, bias, act, gain, clamp):
    return torch.empty_like(x)


@_bias_act_grad_op.register_fake
def _bias_act_grad_fake(g, x, bias, slope, gain, clamp):
    return torch.empty_like(x)


def _bias_act_setup(ctx, inputs, output):
    x, bias, act, gain, clamp = inputs
    slope, act_gain = _ACTS[act]
    ctx.save_for_backward(x, bias)
    ctx.params = (slope, act_gain * gain,
                  None if clamp is None else clamp * gain)


def _bias_act_backward(ctx, dy):
    """dx = B1b(dy, x, b); db = sum(dx) over all but dim 1, only when the
    bias needs it (as ``_fba_bwd`` sums outside its kernel)."""
    x, bias = ctx.saved_tensors
    dx = _bias_act_grad_op(dy.contiguous(), x, bias, *ctx.params)
    db = None
    if ctx.needs_input_grad[1]:
        dims = [d for d in range(dx.dim()) if d != 1]
        ct = torch.promote_types(dx.dtype, torch.float32)
        db = dx.to(ct).sum(dims).to(bias.dtype)
    return dx, db, None, None, None


def _bias_act_grad_setup(ctx, inputs, output):
    g, x, bias, slope, gain, clamp = inputs
    ctx.save_for_backward(x, bias)
    ctx.params = (slope, gain, clamp)


def _bias_act_grad_backward(ctx, ggx):
    """dx is linear in g and piecewise constant in x and b: the gradient
    of B1b is B1b applied to the incoming gradient."""
    x, bias = ctx.saved_tensors
    return (_bias_act_grad_op(ggx.contiguous(), x, bias, *ctx.params),
            None, None, None, None, None)


_bias_act_op.register_autograd(_bias_act_backward,
                               setup_context=_bias_act_setup)
_bias_act_grad_op.register_autograd(_bias_act_grad_backward,
                                    setup_context=_bias_act_grad_setup)


def bias_act_grad(g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
                  slope: float, gain: float,
                  clamp: Optional[float]) -> torch.Tensor:
    """The semantics of ``bias_act_grad_plain`` (differentiable in g, to
    any order): the op ``sgfr::bias_act_grad``, kernel B1b on a CUDA
    tensor (g and x contiguous, of one shape and dtype, f32 or bf16; math
    in f32), the plain version on a CPU one. ``bias_act_grad.launches``
    counts the kernel's launches."""
    build.check_device("bias_act_grad", x)
    return _bias_act_grad_op(g, x, bias, slope, gain, clamp)


def bias_act(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
             act: str = "lrelu", gain: float = 1.0,
             clamp: Optional[float] = None) -> torch.Tensor:
    """The semantics of ``bias_act_plain``, differentiable twice: the op
    ``sgfr::bias_act``, kernels B1 forward and B1b backward on a CUDA
    tensor (contiguous, f32 or bf16, math in f32), the plain versions on a
    CPU one. ``bias_act.launches`` counts B1's launches."""
    if act not in _ACTS:
        raise ValueError(act)
    build.check_device("bias_act", x)
    if bias is None:
        bias = torch.zeros(x.shape[1], device=x.device)
    return _bias_act_op(x, bias, act, float(gain),
                        None if clamp is None else float(clamp))


def fused_leaky_relu(x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     negative_slope: float = 0.2,
                     scale: float = _SQRT2) -> torch.Tensor:
    """``(x + b >= 0 ? x + b : slope (x + b)) * scale``, bias over dim 1 of
    an (N, C, ...) or (N, C) input: ``bias_act(act="lrelu", gain=scale /
    sqrt(2), clamp=None)``, so kernels B1 and B1b serve it on the card.
    Only the slope 0.2 of B1's lrelu is taken."""
    if negative_slope != _ACTS["lrelu"][0]:
        raise ValueError(f"fused_leaky_relu: slope {negative_slope}, the "
                         f"kernel's lrelu has 0.2")
    return bias_act(x, bias, act="lrelu", gain=scale / _SQRT2)


def clamp_gain(x: torch.Tensor, gain: float, clamp: float) -> torch.Tensor:
    """``clip(x * gain, -clamp, clamp)``."""
    return torch.clamp(x * gain, -clamp, clamp)


bias_act.launches = 0
bias_act_grad.launches = 0
