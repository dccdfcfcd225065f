"""Post-training int8 quantization for serving, as
``stylegan_for_facerec_tpu/utils/quantize.py``.

No model changes beyond the two modulated-conv sites: a hook installed
with ``hooked(hook)`` takes over every call of a plain ``torch.nn.Conv2d``
or ``torch.nn.Linear`` (exactly those classes: a subclass such as
EfficientNet's ``SamePadConv`` runs as it is, as the JAX package leaves
its ``SamePadConv`` alone) and the modulated convs of
``models.stylegan2_ada``'s ``SynthesisLayer`` and ``ToRGBLayer``, which
consult ``active_hook()``. Nothing else is hooked: not
``FullyConnectedLayer``, ``EqualLinear``, ``EqualizedConv2d``, nor the blur
and upfirdn convolutions. Calls are identified by their ORDER, as in the
JAX package, so one module called five times (``run_on_batch``) owns five
entries, and a table calibrated by either package lines up with the other
(``Int8Table.from_jax``).

Scheme: symmetric int8. Weights have per-output-channel scales (absmax /
127 over the receptive field), activations one per-tensor scale, the
running absmax over the calibration batches. Codes are
``clip(round_half_even(v / scale), -127, 127)`` computed in f32; products
accumulate in int32 (``int8_matmul``: ``torch._int_mm``, with zero padding
to its CUDA shape rules, which is exact; a grouped conv sums its int32
products per group), and the rescale is ``acc.float() * (x_scale *
w_scale)`` then the f32 bias, in that order, so the same int8 codes give
JAX's accumulators and outputs bit for bit. Modulated convs quantize the
style-scaled activation against the static base weight and demodulate in
f32 from the recorded ``w_sq`` (sum over the taps of weight^2). BatchNorm,
PReLU, pooling and the residual adds stay in the activation dtype.

Layouts are the port's: conv and modconv weights (O, I, kh, kw), linear
(out, in), ``w_scale`` (O,), ``w_sq`` (O, I).

    table = calibrate_and_quantize(model, batches)
    lean = strip_quantized_weights(model, table)    # f32 weights dropped
    emb = quantized_apply(lean, images, table)
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.modconv import modulated_conv2d

_ACTIVE = None
_CONV_FORWARD = nn.Conv2d.forward
_LINEAR_FORWARD = nn.Linear.forward


def active_hook():
    """The hook installed by ``hooked``, or None."""
    return _ACTIVE


def _conv_forward(self, x):
    if _ACTIVE is None or type(self) is not nn.Conv2d:
        return _CONV_FORWARD(self, x)
    return _ACTIVE.conv2d(self, x)


def _linear_forward(self, x):
    if _ACTIVE is None or type(self) is not nn.Linear:
        return _LINEAR_FORWARD(self, x)
    return _ACTIVE.linear(self, x)


@contextlib.contextmanager
def hooked(hook):
    """Route every ``nn.Conv2d``/``nn.Linear`` call and the two modconv
    sites through ``hook`` (a ``_Recorder`` or ``Int8Apply``) while the
    context is open."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a quantization hook is already installed")
    _ACTIVE = hook
    nn.Conv2d.forward, nn.Linear.forward = _conv_forward, _linear_forward
    try:
        yield hook
    finally:
        _ACTIVE = None
        nn.Conv2d.forward, nn.Linear.forward = (_CONV_FORWARD,
                                                _LINEAR_FORWARD)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel (axis 0) int8: (codes, scale (O,))."""
    w = w.detach().float()
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def quantize_act(x: torch.Tensor, absmax: torch.Tensor):
    """Per-tensor int8 codes of x with the static scale absmax / 127."""
    scale = torch.clamp(absmax.float(), min=1e-12) / 127.0
    xq = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return xq.to(torch.int8), scale


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact. On a CUDA tensor
    cuBLASLt's int8 product (``torch._int_mm``) needs M > 16 and K, N
    multiples of 8: zero rows and columns pad it, which adds nothing."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b)
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        # column-major (K, N), the layout the product takes B in
        b = F.pad(b.t(), (0, kp - k, 0, np_ - n)).t()
    out = torch._int_mm(a.contiguous(), b)
    return out[:m, :n] if (mp, np_) != (m, n) else out


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, stride=1, padding=0,
                groups: int = 1) -> torch.Tensor:
    """Cross-correlation of int8 codes xq (N, C, H, W) with wq (O, C /
    groups, kh, kw) -> int32 (N, Ho, Wo, O), summed in int32 throughout:
    zero padding, the patches gathered by ``Tensor.unfold`` (K in the
    weight's (C, kh, kw) order), then ``int8_matmul`` (groups 1), an int32
    multiply-sum over the patches (one output a group: depthwise), or one
    product per group."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    o, cg, kh, kw = wq.shape
    if ph or pw:
        xq = F.pad(xq, (pw, pw, ph, ph))
    # (N, C, Ho, Wo, kh, kw) -> (N, Ho, Wo, C, kh, kw)
    p = xq.unfold(2, kh, sh).unfold(3, kw, sw).permute(0, 2, 3, 1, 4, 5)
    n, ho, wo = p.shape[:3]
    m = n * ho * wo
    if groups == 1:
        y = int8_matmul(p.reshape(m, cg * kh * kw),
                        wq.reshape(o, -1).t())
    elif o == groups:
        y = (p.reshape(m, groups, cg * kh * kw).to(torch.int32)
             * wq.reshape(o, -1).to(torch.int32)).sum(-1)
    else:
        og = o // groups
        pg = p.reshape(m, groups, cg * kh * kw)
        wg = wq.reshape(groups, og, -1)
        y = torch.cat([int8_matmul(pg[:, i], wg[i].t())
                       for i in range(groups)], dim=1)
    return y.reshape(n, ho, wo, o)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> an (N, C, H, W) view in channels-last memory."""
    return y.permute(0, 3, 1, 2)


class _Recorder:
    """Calibration hook: runs the ordinary f32 forward while recording
    each call's activation absmax (running max over batches) and, on the
    first batch, the int8 weights."""

    def __init__(self):
        self.entries: List[Dict[str, torch.Tensor]] = []
        self.kinds: List[str] = []
        self.weight_ids = set()
        self._i = 0
        self._first = True

    def begin_batch(self):
        self._first = not self.entries
        self._i = 0

    def _observe(self, kind: str, weight: torch.Tensor, x: torch.Tensor,
                 demod: bool = False):
        i = self._i
        self._i += 1
        absmax = x.detach().abs().amax().float()
        if self._first:
            wq, w_scale = quantize_weight(weight)
            entry = {"w": wq, "w_scale": w_scale, "x_absmax": absmax}
            if demod:
                entry["w_sq"] = weight.detach().float().square().sum(
                    dim=(2, 3))
            self.entries.append(entry)
            self.kinds.append(kind)
            self.weight_ids.add(id(weight))
            return
        if i >= len(self.entries) or self.kinds[i] != kind:
            raise ValueError(
                f"call order diverged between calibration batches at "
                f"call {i} ({kind}); the model's conv/linear call "
                f"sequence must be static")
        e = self.entries[i]
        e["x_absmax"] = torch.maximum(e["x_absmax"], absmax)

    def conv2d(self, layer: nn.Conv2d, x):
        self._observe("conv2d", layer.weight, x)
        return _CONV_FORWARD(layer, x)

    def linear(self, layer: nn.Linear, x):
        self._observe("linear", layer.weight, x)
        return _LINEAR_FORWARD(layer, x)

    def modconv(self, weight, x, styles, padding: int, demodulate: bool):
        x_mod = x * styles.to(x.dtype)[:, :, None, None]
        self._observe("modconv", weight, x_mod, demod=demodulate)
        return modulated_conv2d(x, weight, styles, padding=padding,
                                demodulate=demodulate)


class Int8Apply:
    """Serving hook: call i quantizes its activation with entry i's
    calibrated scale and runs int8 x int8 -> int32."""

    def __init__(self, entries: List[Dict[str, torch.Tensor]]):
        self.entries = entries
        self._i = 0

    def _take(self, kind: str):
        i = self._i
        self._i += 1
        if i >= len(self.entries):
            raise ValueError(
                f"quantized table has {len(self.entries)} entries but the "
                f"model issued call {i} ({kind}); re-run "
                f"calibrate_and_quantize for this model configuration")
        return self.entries[i]

    @staticmethod
    def _rescale(acc, x_scale, e, bias):
        y = acc.float() * (x_scale * e["w_scale"])
        if bias is not None:
            y = y + bias.float()
        return y

    def conv2d(self, layer: nn.Conv2d, x):
        e = self._take("conv2d")
        if (layer.dilation != (1, 1) or layer.padding_mode != "zeros"
                or isinstance(layer.padding, str)):
            raise ValueError("int8 conv2d: dilation 1 and explicit zero "
                             "padding only")
        xq, x_scale = quantize_act(x, e["x_absmax"])
        acc = int8_conv2d(xq, e["w"], layer.stride, layer.padding,
                          layer.groups)
        return _nchw(self._rescale(acc, x_scale, e, layer.bias)).to(x.dtype)

    def linear(self, layer: nn.Linear, x):
        e = self._take("linear")
        xq, x_scale = quantize_act(x, e["x_absmax"])
        lead = xq.shape[:-1]
        acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), e["w"].t())
        y = self._rescale(acc, x_scale, e, layer.bias)
        return y.reshape(*lead, -1).to(x.dtype)

    def modconv(self, weight, x, styles, padding: int, demodulate: bool):
        """int8 modulated conv: the style-scaled activation quantized with
        the calibrated scale, the int8 base weight, the rescale, then f32
        demodulation (the eps of ``ops/modconv.py``)."""
        e = self._take("modconv")
        x_mod = x * styles.to(x.dtype)[:, :, None, None]
        xq, x_scale = quantize_act(x_mod, e["x_absmax"])
        y = self._rescale(int8_conv2d(xq, e["w"], 1, padding), x_scale, e,
                          None)
        if demodulate:
            ssq = styles.float().square()
            y = y * torch.rsqrt(ssq @ e["w_sq"].t() + 1e-8)[:, None, None]
        return _nchw(y).to(x.dtype).contiguous()


@dataclasses.dataclass
class Int8Table:
    """A calibrated table: ``entries`` (one dict of tensors a hooked call),
    ``kinds`` ("conv2d", "linear" or "modconv" a call) and ``weight_ids``
    (the ids of the quantized weight Parameters, which
    ``strip_quantized_weights`` drops)."""

    entries: List[Dict[str, torch.Tensor]]
    kinds: List[str]
    weight_ids: set = dataclasses.field(default_factory=set)

    def nbytes(self) -> int:
        """Bytes of the int8 weights."""
        return sum(int(e["w"].numel()) for e in self.entries)

    def to(self, device) -> "Int8Table":
        return Int8Table([{k: v.to(device) for k, v in e.items()}
                          for e in self.entries], list(self.kinds),
                         set(self.weight_ids))

    @classmethod
    def from_jax(cls, entries: List[Mapping[str, Any]], kinds: List[str],
                 flatten_hw: Optional[Mapping[int, tuple]] = None
                 ) -> "Int8Table":
        """A JAX package table (``Int8Table.entries`` and the recorder's
        ``kinds``) in the port's layouts: conv and modconv weights HWIO ->
        OIHW, linear (in, out) -> (out, in), ``w_sq`` (I, O) -> (O, I).
        ``flatten_hw`` maps the index of a linear entry whose input was a
        flattened (H, W) map to that (H, W): the JAX package flattens
        NHWC in (H, W, C) order and the port NCHW in (C, H, W), so that
        weight's input axis is permuted too (as ``utils.convert`` does).
        The table has no ``weight_ids``: strip with a port calibration."""
        flatten_hw = flatten_hw or {}
        out = []
        for i, (e, kind) in enumerate(zip(entries, kinds)):
            w = np.asarray(e["w"])
            if kind == "linear":
                if i in flatten_hw:
                    h, wd = flatten_hw[i]
                    o = w.shape[1]
                    w = w.reshape(h, wd, -1, o).transpose(3, 2, 0, 1)
                    w = w.reshape(o, -1)
                else:
                    w = w.T
            else:
                w = np.transpose(w, (3, 2, 0, 1))
            d = {"w": torch.from_numpy(np.ascontiguousarray(w)),
                 "w_scale": torch.from_numpy(
                     np.asarray(e["w_scale"], np.float32).copy()),
                 "x_absmax": torch.tensor(np.asarray(e["x_absmax"]),
                                          dtype=torch.float32)}
            if "w_sq" in e:
                d["w_sq"] = torch.from_numpy(np.ascontiguousarray(
                    np.asarray(e["w_sq"], np.float32).T))
            out.append(d)
        return cls(out, list(kinds))


def _table(rec: _Recorder, n: int) -> Int8Table:
    if n == 0 or not rec.entries:
        raise ValueError("calibration needs >=1 batch and >=1 hooked "
                         "nn.Conv2d/nn.Linear/modconv call")
    return Int8Table(rec.entries, rec.kinds, rec.weight_ids)


def calibrate_with(forward: Callable, batches: Iterable) -> Int8Table:
    """Calibrate any model surface: ``forward(x, hook)`` must run the whole
    computation with ``hook`` installed (``hooked(hook)``, or
    ``run_on_batch(..., quant=hook)``), e.g. the inversion loop, whose
    iterations each issue their own calls."""
    rec = _Recorder()
    n = 0
    with torch.no_grad():
        for x in batches:
            rec.begin_batch()
            forward(x, rec)
            n += 1
    return _table(rec, n)


def calibrate_and_quantize(model: nn.Module, batches: Iterable,
                           **forward_kwargs) -> Int8Table:
    """Run ``model(x, **forward_kwargs)`` in eval mode over ``batches``
    (model inputs; NCHW images for an embedder, z for a generator with
    ``noise_mode="const"``), recording each call's activation absmax and
    the per-output-channel int8 weights. The running max makes the order
    of the batches irrelevant."""
    was_training = model.training
    model.eval()

    def forward(x, rec):
        with hooked(rec):
            model(x, **forward_kwargs)

    try:
        return calibrate_with(forward, batches)
    finally:
        model.train(was_training)


def strip_quantized_weights(model: nn.Module, table: Int8Table) -> nn.Module:
    """A copy of ``model`` whose quantized weights are 0-d int8
    placeholders (the serving hook never reads them, as the JAX package's
    stripped tree); biases and everything else are copied. Drop the
    original to free its f32 weights."""
    memo = {}
    for p in model.parameters():
        if id(p) in table.weight_ids:
            memo[id(p)] = nn.Parameter(
                torch.zeros((), dtype=torch.int8, device=p.device),
                requires_grad=False)
    return copy.deepcopy(model, memo)


def quantized_apply(model: nn.Module, x, table: Int8Table, **forward_kwargs):
    """The int8 forward ``model(x, **forward_kwargs)`` under ``no_grad``
    with a fresh ``Int8Apply`` over ``table``'s entries (so the call
    counter starts at 0 each time)."""
    with torch.no_grad(), hooked(Int8Apply(table.entries)):
        return model(x, **forward_kwargs)
