"""MobileFaceNet (NCHW), as ``stylegan_for_facerec_tpu/models/
mobilefacenet.py``: depthwise-separable bottlenecks with PReLU, a global
depthwise conv over the last (out_h, out_w) map, Linear(512 -> emb, no
bias) -> BN1d. Module names follow the reference torch tree
(``conv1.conv``, ``conv_23.conv_dw.bn``, ``conv_3.model.0.project.conv``,
``conv_6_dw``, ``linear``, ``bn``), which ``utils.convert.from_jax``
fills. The convs take torch's default init, ``linear`` xavier-uniform.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.initializers import init_conv_torch_default_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d


class LinearBlock(nn.Module):
    """conv (no bias) -> BN."""

    def __init__(self, in_c: int, out_c: int, kernel=1, stride=1,
                 padding=0, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_c, out_c, kernel, stride=stride,
                              padding=padding, groups=groups, bias=False)
        self.bn = BatchNorm2d(out_c)

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class ConvBlock(LinearBlock):
    """conv (no bias) -> BN -> PReLU."""

    def __init__(self, in_c: int, out_c: int, kernel=1, stride=1,
                 padding=0, groups: int = 1):
        super().__init__(in_c, out_c, kernel, stride, padding, groups)
        self.prelu = nn.PReLU(out_c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.bn(self.conv(x)))


class DepthWise(nn.Module):
    """1x1 expand to ``groups`` channels -> depthwise kxk(stride) -> 1x1
    project, with the input added when ``residual``. ``groups`` is the
    expansion width, as in the reference."""

    def __init__(self, in_c: int, out_c: int, residual: bool = False,
                 kernel: int = 3, stride: int = 2, padding: int = 1,
                 groups: int = 1):
        super().__init__()
        self.conv = ConvBlock(in_c, groups, 1)
        self.conv_dw = ConvBlock(groups, groups, kernel, stride, padding,
                                 groups=groups)
        self.project = LinearBlock(groups, out_c, 1)
        self.residual = residual

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.project(self.conv_dw(self.conv(x)))
        return h + x if self.residual else h


class Residual(nn.Module):
    """``num_block`` residual ``DepthWise`` units under ``model``."""

    def __init__(self, c: int, num_block: int, groups: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.model = nn.Sequential(*[
            DepthWise(c, c, residual=True, kernel=kernel, stride=stride,
                      padding=padding, groups=groups)
            for _ in range(num_block)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class MobileFaceNet(nn.Module):
    """(N, 3, 112, 112) -> (N, embedding_size). ``out_h``/``out_w``: the
    last map, which the global depthwise conv covers (7 x 7 at 112 px)."""

    def __init__(self, embedding_size: int = 512, out_h: int = 7,
                 out_w: int = 7):
        super().__init__()
        self.conv1 = ConvBlock(3, 64, 3, 2, 1)
        self.conv2_dw = ConvBlock(64, 64, 3, 1, 1, groups=64)
        self.conv_23 = DepthWise(64, 64, kernel=3, stride=2, padding=1,
                                 groups=128)
        self.conv_3 = Residual(64, 4, 128)
        self.conv_34 = DepthWise(64, 128, kernel=3, stride=2, padding=1,
                                 groups=256)
        self.conv_4 = Residual(128, 6, 256)
        self.conv_45 = DepthWise(128, 128, kernel=3, stride=2, padding=1,
                                 groups=512)
        self.conv_5 = Residual(128, 2, 256)
        self.conv_6_sep = ConvBlock(128, 512, 1)
        self.conv_6_dw = LinearBlock(512, 512, kernel=(out_h, out_w),
                                     groups=512)
        self.linear = nn.Linear(512, embedding_size, bias=False)
        self.bn = BatchNorm1d(embedding_size)

    def init_weights_(self, generator: torch.Generator):
        xavier_uniform_(self.linear.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in ("conv1", "conv2_dw", "conv_23", "conv_3", "conv_34",
                     "conv_4", "conv_45", "conv_5", "conv_6_sep",
                     "conv_6_dw"):
            x = getattr(self, name)(x)
        return self.bn(self.linear(torch.flatten(x, 1)))
