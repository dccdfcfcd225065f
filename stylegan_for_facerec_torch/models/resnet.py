"""The ResNet basic block (NCHW), as ``stylegan_for_facerec_tpu/models/
resnet.py::BasicBlock``: the unit of the resnet34 trunk of
``models.psp.ResNetBackboneEncoder``. Module names follow torchvision's
(``conv1``, ``bn1``, ``conv2``, ``bn2``, ``downsample.0``/``.1``)."""

from __future__ import annotations

import torch
from torch import nn

from ..nn.initializers import init_conv_torch_default_
from ..nn.layers import BatchNorm2d


class BasicBlock(nn.Module):
    """conv3x3(stride) -> BN -> ReLU -> conv3x3 -> BN, plus the identity
    or, with ``has_downsample``, a 1x1 conv(stride) + BN; then ReLU. Init:
    torch's default for the convs, the last BN's weight zero."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
            BatchNorm2d(planes)) if has_downsample else None

    def init_weights_(self, generator: torch.Generator):
        convs = [self.conv1, self.conv2]
        if self.downsample is not None:
            convs.append(self.downsample[0])
        for conv in convs:
            init_conv_torch_default_(conv, generator)
        with torch.no_grad():
            self.bn2.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)
