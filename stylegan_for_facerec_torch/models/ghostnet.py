"""GhostNet face-recognition backbone (NCHW), as
``stylegan_for_facerec_tpu/models/ghostnet.py``: ghost modules (a primary
conv plus cheap depthwise "ghost" features, concatenated and cut to
width), ghost bottlenecks with an optional hard-sigmoid squeeze-excite, a
stride-1 stem, and a BN -> Dropout -> Flatten -> Linear(960 h w -> feat)
-> BN1d head. Module names follow the reference torch tree
(``blocks.6.3.ghost1.primary_conv.0``, ``blocks.9.0.conv``,
``output_layer.3``), which ``utils.convert.from_jax`` fills; the convs
take torch's default init, the embedding Linear xavier-uniform.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.initializers import init_conv_torch_default_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d, Dropout, Flatten


def _make_divisible(v, divisor=4, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _conv(ci, co, k=1, stride=1, groups=1, bias=False):
    return nn.Conv2d(ci, co, k, stride=stride, padding=(k - 1) // 2,
                     groups=groups, bias=bias)


class _TorchDefaultInit(nn.Module):
    """Draws every conv directly under it with torch's default init."""

    def init_weights_(self, generator: torch.Generator):
        for m in self.children():
            mods = m if isinstance(m, nn.Sequential) else [m]
            for c in mods:
                if isinstance(c, nn.Conv2d):
                    init_conv_torch_default_(c, generator)


class SqueezeExcite(_TorchDefaultInit):
    """Global mean -> conv1x1 (with bias) -> ReLU -> conv1x1 (with bias)
    -> hard sigmoid -> channel gate."""

    def __init__(self, in_chs: int, se_ratio: float = 0.25):
        super().__init__()
        red = _make_divisible(in_chs * se_ratio, 4)
        self.conv_reduce = _conv(in_chs, red, bias=True)
        self.conv_expand = _conv(red, in_chs, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(torch.relu(self.conv_reduce(s)))
        return x * hard_sigmoid(s)


class GhostModule(_TorchDefaultInit):
    """Primary conv + BN to ceil(oup / ratio) channels, cheap depthwise
    conv + BN to (ratio - 1) times that, each with ReLU when ``relu``;
    concatenated and cut to ``oup`` channels."""

    def __init__(self, inp: int, oup: int, kernel_size: int = 1,
                 ratio: int = 2, dw_size: int = 3, stride: int = 1,
                 relu: bool = True):
        super().__init__()
        self.oup, self.relu = oup, relu
        init_ch = math.ceil(oup / ratio)
        new_ch = init_ch * (ratio - 1)
        self.primary_conv = nn.Sequential(
            _conv(inp, init_ch, kernel_size, stride), BatchNorm2d(init_ch))
        self.cheap_operation = nn.Sequential(
            _conv(init_ch, new_ch, dw_size, groups=init_ch),
            BatchNorm2d(new_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.primary_conv(x)
        if self.relu:
            x1 = torch.relu(x1)
        x2 = self.cheap_operation(x1)
        if self.relu:
            x2 = torch.relu(x2)
        return torch.cat([x1, x2], dim=1)[:, :self.oup]


class GhostBottleneck(_TorchDefaultInit):
    """ghost1 (ReLU) [-> depthwise conv(stride) -> BN] [-> squeeze-excite]
    -> ghost2 (no ReLU), plus the input or a depthwise conv(stride) -> BN
    -> conv1x1 -> BN shortcut where the width or stride changes."""

    def __init__(self, in_chs: int, mid_chs: int, out_chs: int,
                 dw_kernel_size: int = 3, stride: int = 1,
                 se_ratio: float = 0.0):
        super().__init__()
        self.stride = stride
        self.ghost1 = GhostModule(in_chs, mid_chs, relu=True)
        if stride > 1:
            self.conv_dw = _conv(mid_chs, mid_chs, dw_kernel_size, stride,
                                 groups=mid_chs)
            self.bn_dw = BatchNorm2d(mid_chs)
        self.se = (SqueezeExcite(mid_chs, se_ratio)
                   if se_ratio and se_ratio > 0 else None)
        self.ghost2 = GhostModule(mid_chs, out_chs, relu=False)
        self.shortcut = None
        if not (in_chs == out_chs and stride == 1):
            self.shortcut = nn.Sequential(
                _conv(in_chs, in_chs, dw_kernel_size, stride,
                      groups=in_chs),
                BatchNorm2d(in_chs), _conv(in_chs, out_chs),
                BatchNorm2d(out_chs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.ghost1(x)
        if self.stride > 1:
            x = self.bn_dw(self.conv_dw(x))
        if self.se is not None:
            x = self.se(x)
        x = self.ghost2(x)
        if self.shortcut is not None:
            residual = self.shortcut(residual)
        return x + residual


class ConvBnAct(_TorchDefaultInit):
    """conv1x1 (``conv``) -> BN (``bn1``) -> ReLU."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = _conv(in_ch, out_ch)
        self.bn1 = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn1(self.conv(x)))


def _FinalConvBnAct(in_ch: int, out_ch: int) -> nn.Sequential:
    """The last stage, ``blocks.<last>.0``: one ``ConvBnAct``."""
    return nn.Sequential(ConvBnAct(in_ch, out_ch))


# (kernel, expansion, out channels, se ratio, stride) of each bottleneck,
# one tuple per stage
GHOSTNET_CFGS = (
    ((3, 16, 16, 0.0, 1),),
    ((3, 48, 24, 0.0, 2),),
    ((3, 72, 24, 0.0, 1),),
    ((5, 72, 40, 0.25, 2),),
    ((5, 120, 40, 0.25, 1),),
    ((3, 240, 80, 0.0, 2),),
    ((3, 200, 80, 0.0, 1), (3, 184, 80, 0.0, 1), (3, 184, 80, 0.0, 1),
     (3, 480, 112, 0.25, 1), (3, 672, 112, 0.25, 1)),
    ((5, 672, 160, 0.25, 2),),
    ((5, 960, 160, 0.0, 1), (5, 960, 160, 0.25, 1), (5, 960, 160, 0.0, 1),
     (5, 960, 160, 0.25, 1)),
)


class GhostNet(_TorchDefaultInit):
    """Stride-1 stem conv3x3 -> BN -> ReLU, the nine ghost stages and the
    final ``ConvBnAct`` (112 px -> 7 x 7 x 960 at width 1), then the
    output layer."""

    def __init__(self, width: float = 1.0, drop_ratio: float = 0.2,
                 feat_dim: int = 512, out_h: int = 7, out_w: int = 7):
        super().__init__()
        out_ch = _make_divisible(16 * width, 4)
        self.conv_stem = _conv(3, out_ch, 3)
        self.bn1 = BatchNorm2d(out_ch)
        in_ch, stages, exp = out_ch, [], 16
        for cfg in GHOSTNET_CFGS:
            blocks = []
            for k, exp, c, se, s in cfg:
                out_c = _make_divisible(c * width, 4)
                mid_c = _make_divisible(exp * width, 4)
                blocks.append(GhostBottleneck(in_ch, mid_c, out_c, k, s,
                                              se_ratio=se))
                in_ch = out_c
            stages.append(nn.Sequential(*blocks))
        out_c = _make_divisible(exp * width, 4)
        stages.append(_FinalConvBnAct(in_ch, out_c))
        self.blocks = nn.Sequential(*stages)
        self.output_layer = nn.Sequential(
            BatchNorm2d(out_c), Dropout(drop_ratio), Flatten((out_h, out_w)),
            nn.Linear(out_c * out_h * out_w, feat_dim),
            BatchNorm1d(feat_dim))

    def init_weights_(self, generator: torch.Generator):
        super().init_weights_(generator)
        linear = self.output_layer[3]
        xavier_uniform_(linear.weight, generator)
        with torch.no_grad():
            linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv_stem(x)))
        return self.output_layer(self.blocks(x))
