"""IR-SE ResNet blocks of the pSp encoder (NCHW).

Module names follow the reference torch tree (``body.3.res_layer.1``,
``res_layer.5.fc1``), which ``utils.convert.from_jax`` fills.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..nn.initializers import init_conv_xavier_
from ..nn.layers import Subsample


class SEModule(nn.Module):
    """Squeeze-excitation: global average pool -> 1x1 conv C/r -> ReLU ->
    1x1 conv C -> sigmoid -> channel gate."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1, bias=False)

    def init_weights_(self, generator: torch.Generator):
        init_conv_xavier_(self.fc1, generator)
        init_conv_xavier_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
        return x * s


class BottleneckIR(nn.Module):
    """Shortcut (subsample, or 1x1 conv + BN) plus the residual
    BN -> conv3x3 -> PReLU -> conv3x3(stride) -> BN [-> SE]."""

    def __init__(self, in_channel: int, depth: int, stride: int,
                 se: bool = False):
        super().__init__()
        if in_channel == depth:
            self.shortcut_layer = Subsample(stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride=stride, bias=False),
                nn.BatchNorm2d(depth))
        res = [nn.BatchNorm2d(in_channel),
               nn.Conv2d(in_channel, depth, 3, padding=1, bias=False),
               nn.PReLU(depth),
               nn.Conv2d(depth, depth, 3, stride=stride, padding=1,
                         bias=False),
               nn.BatchNorm2d(depth)]
        if se:
            res.append(SEModule(depth, 16))
        self.res_layer = nn.Sequential(*res)

    def init_weights_(self, generator: torch.Generator):
        convs = [self.res_layer[1], self.res_layer[3]]
        if isinstance(self.shortcut_layer, nn.Sequential):
            convs.append(self.shortcut_layer[0])
        for conv in convs:
            init_conv_xavier_(conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res_layer(x) + self.shortcut_layer(x)


def get_blocks(num_layers: int) -> Tuple[Tuple[int, int, int], ...]:
    """(in_channel, depth, stride) of each unit of the IR-34/50/100/152
    bodies."""
    layouts = {
        34: [(64, 64, 3), (64, 128, 4), (128, 256, 6), (256, 512, 3)],
        50: [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)],
        100: [(64, 64, 3), (64, 128, 13), (128, 256, 30), (256, 512, 3)],
        152: [(64, 64, 3), (64, 128, 8), (128, 256, 36), (256, 512, 3)],
    }
    if num_layers not in layouts:
        raise ValueError(f"num_layers must be one of {sorted(layouts)}")
    units = []
    for in_ch, depth, n in layouts[num_layers]:
        units += [(in_ch, depth, 2)] + [(depth, depth, 1)] * (n - 1)
    return tuple(units)
