"""EfficientNet-B0..B7 face-recognition backbone (NCHW), as
``stylegan_for_facerec_tpu/models/efficientnet.py``: TF "same"-padded
convs, swish, MBConv blocks (expand -> depthwise -> squeeze-excite ->
project, identity skip with drop connect), a stride-1 stem for 112 px
faces, the 1280-channel conv head, then BN2d -> Dropout -> Flatten ->
Linear(1280 h w -> feat) -> BN1d. Module names follow the reference
torch tree (``_conv_stem``, ``_blocks.3._depthwise_conv``,
``output_layer.3``), which ``utils.convert.from_jax`` fills. Drop connect
and dropout draw from the explicit generator of ``nn.layers.Dropout``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import init_conv_torch_default_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d, Dropout, Flatten


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_f = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * filters:
        new_f += divisor
    return int(new_f)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: float = 0.25
    id_skip: bool = True


# the B0 block table
B0_BLOCKS = (
    BlockArgs(1, 3, 1, 1, 32, 16),
    BlockArgs(2, 3, 2, 6, 16, 24),
    BlockArgs(2, 5, 2, 6, 24, 40),
    BlockArgs(3, 3, 2, 6, 40, 80),
    BlockArgs(3, 5, 1, 6, 80, 112),
    BlockArgs(4, 5, 2, 6, 112, 192),
    BlockArgs(1, 3, 1, 6, 192, 320),
)

# (width, depth, dropout) of each variant
VARIANTS = {
    "b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2), "b2": (1.1, 1.2, 0.3),
    "b3": (1.2, 1.4, 0.3), "b4": (1.4, 1.8, 0.4), "b5": (1.6, 2.2, 0.4),
    "b6": (1.8, 2.6, 0.5), "b7": (2.0, 3.1, 0.5),
}


def _same_pad(i: int, k: int, s: int) -> Tuple[int, int]:
    """TF "SAME" padding of one axis: (before, after), the odd pixel
    after."""
    pad = max((-(-i // s) - 1) * s + k - i, 0)
    return pad // 2, pad - pad // 2


class SamePadConv(nn.Conv2d):
    """A conv with TF "same" padding for the input's size, asymmetric
    where the total is odd. Torch's default init."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, groups=groups, bias=bias)

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        ph = _same_pad(x.shape[2], k, s)
        pw = _same_pad(x.shape[3], k, s)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return super().forward(x)


class DropConnect(Dropout):
    """Drop connect: in train mode each sample's whole residual branch is
    kept with probability 1 - p (and divided by it) or zeroed, the mask
    drawn from ``generator`` as ``Dropout``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError("DropConnect in train mode draws its mask from "
                             "an explicit torch.Generator: set .generator")
        keep = 1.0 - self.p
        mask = torch.empty((x.shape[0], 1, 1, 1), dtype=x.dtype,
                           device=x.device).bernoulli_(
                               keep, generator=self.generator)
        return x * mask / keep


class MBConvBlock(nn.Module):
    """Expand (1x1, when expand_ratio != 1) -> BN -> swish -> depthwise
    kxk(stride) -> BN -> swish -> squeeze-excite -> project 1x1 -> BN;
    plus the input, after drop connect at ``drop_connect_rate``, when the
    block keeps its width and stride 1. BN momentum 0.01, eps 1e-3."""

    def __init__(self, args: BlockArgs, drop_connect_rate: float = 0.0,
                 bn_mom: float = 0.01, bn_eps: float = 1e-3):
        super().__init__()
        a = self.args = args
        inp, oup = a.input_filters, a.input_filters * a.expand_ratio
        bn = dict(eps=bn_eps, momentum=bn_mom)
        if a.expand_ratio != 1:
            self._expand_conv = SamePadConv(inp, oup, 1)
            self._bn0 = BatchNorm2d(oup, **bn)
        self._depthwise_conv = SamePadConv(oup, oup, a.kernel_size,
                                           a.stride, groups=oup)
        self._bn1 = BatchNorm2d(oup, **bn)
        self.has_se = bool(a.se_ratio) and 0 < a.se_ratio <= 1
        if self.has_se:
            sq = max(1, int(inp * a.se_ratio))
            self._se_reduce = SamePadConv(oup, sq, 1, bias=True)
            self._se_expand = SamePadConv(sq, oup, 1, bias=True)
        self._project_conv = SamePadConv(oup, a.output_filters, 1)
        self._bn2 = BatchNorm2d(a.output_filters, **bn)
        self.skip = (a.id_skip and a.stride == 1
                     and a.input_filters == a.output_filters)
        self.drop_connect = DropConnect(drop_connect_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        if self.args.expand_ratio != 1:
            x = swish(self._bn0(self._expand_conv(x)))
        x = swish(self._bn1(self._depthwise_conv(x)))
        if self.has_se:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(swish(self._se_reduce(s)))
            x = torch.sigmoid(s) * x
        x = self._bn2(self._project_conv(x))
        if self.skip:
            x = self.drop_connect(x) + inputs
        return x


class EfficientNet(nn.Module):
    """The stride-1-stem variant: at 112 px the last map is 7 x 7. Block i
    of n drops connections at ``drop_connect_rate * i / n``."""

    def __init__(self, variant: str = "b0", feat_dim: int = 512,
                 out_h: int = 7, out_w: int = 7,
                 drop_connect_rate: float = 0.2):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}: {sorted(VARIANTS)}")
        self.variant = variant
        width, _, dropout = VARIANTS[variant]
        stem_ch = round_filters(32, width)
        self._conv_stem = SamePadConv(3, stem_ch, 3, stride=1)
        self._bn0 = BatchNorm2d(stem_ch, eps=1e-3, momentum=0.01)
        blocks = self.scaled_blocks(variant)
        self._blocks = nn.ModuleList([
            MBConvBlock(ba, drop_connect_rate * i / len(blocks))
            for i, ba in enumerate(blocks)])
        head_in = blocks[-1].output_filters
        head_out = round_filters(1280, width)
        self._conv_head = SamePadConv(head_in, head_out, 1)
        self._bn1 = BatchNorm2d(head_out, eps=1e-3, momentum=0.01)
        self.output_layer = nn.Sequential(
            BatchNorm2d(head_out), Dropout(dropout), Flatten((out_h, out_w)),
            nn.Linear(head_out * out_h * out_w, feat_dim),
            BatchNorm1d(feat_dim))

    @staticmethod
    def scaled_blocks(variant: str):
        """The variant's blocks, one ``BlockArgs`` each (16 for b0)."""
        width, depth, _ = VARIANTS[variant]
        blocks = []
        for ba in B0_BLOCKS:
            ba = dataclasses.replace(
                ba, input_filters=round_filters(ba.input_filters, width),
                output_filters=round_filters(ba.output_filters, width),
                num_repeat=round_repeats(ba.num_repeat, depth))
            blocks.append(ba)
            if ba.num_repeat > 1:
                ba = dataclasses.replace(ba, input_filters=ba.output_filters,
                                         stride=1)
            for _ in range(blocks[-1].num_repeat - 1):
                blocks.append(dataclasses.replace(ba, num_repeat=1))
        return blocks

    def init_weights_(self, generator: torch.Generator):
        linear = self.output_layer[3]
        xavier_uniform_(linear.weight, generator)
        with torch.no_grad():
            linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = swish(self._bn0(self._conv_stem(x)))
        for block in self._blocks:
            x = block(x)
        x = swish(self._bn1(self._conv_head(x)))
        return self.output_layer(x)


def EfficientNetB0(feat_dim=512, out_h=7, out_w=7):
    return EfficientNet("b0", feat_dim, out_h, out_w)
