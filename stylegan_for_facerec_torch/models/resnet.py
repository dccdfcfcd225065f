"""Standard ResNet blocks and the ResNet-50/101/152 face-recognition
backbones (NCHW), as ``stylegan_for_facerec_tpu/models/resnet.py``.
``BasicBlock`` is also the unit of the resnet34 trunk of
``models.psp.ResNetBackboneEncoder``. Module names follow torchvision's
(``conv1``, ``bn1``, ..., ``downsample.0``/``.1``, ``layer1.0``) and the
reference backbone's head (``bn_o1``, ``fc``, ``bn_o2``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import init_conv_torch_default_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d, Dropout


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


class Bottleneck(nn.Module):
    """conv1x1 -> BN -> ReLU -> conv3x3(stride) -> BN -> ReLU -> conv1x1
    (4 planes) -> BN, plus the identity or a 1x1 conv(stride) + BN; then
    ReLU. Init as ``BasicBlock``: the last BN's weight zero."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
            BatchNorm2d(out)) if has_downsample else None

    def init_weights_(self, generator: torch.Generator):
        convs = [self.conv1, self.conv2, self.conv3]
        if self.downsample is not None:
            convs.append(self.downsample[0])
        for conv in convs:
            init_conv_torch_default_(conv, generator)
        with torch.no_grad():
            self.bn3.weight.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """conv7x7/2 -> BN -> ReLU -> maxpool3x3/2 -> ``layer1..4`` -> BN2d
    (``bn_o1``) -> Dropout(drop_ratio) -> flatten in (C, H, W) order ->
    Linear (``fc``, xavier-uniform, zero bias) -> BN1d (``bn_o2``). The
    JAX package flattens in torch's order too, so ``fc`` converts without
    a permutation. ``fc`` takes a 4 x 4 map at 112 px and an 8 x 8 map
    otherwise (224 px)."""

    def __init__(self, input_size: int = 112,
                 layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 block: str = "bottleneck", emb_size: int = 512,
                 drop_ratio: float = 0.5):
        super().__init__()
        if block not in ("basic", "bottleneck"):
            raise ValueError(f"block {block!r}: basic|bottleneck")
        cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 layers), 1):
            stride = 1 if i == 1 else 2
            units = [cls(inplanes, planes, stride, has_downsample=(
                stride != 1 or inplanes != planes * cls.expansion))]
            inplanes = planes * cls.expansion
            units += [cls(inplanes, planes) for _ in range(1, blocks)]
            setattr(self, f"layer{i}", nn.Sequential(*units))
        sp = 4 if input_size == 112 else 8
        self.bn_o1 = BatchNorm2d(inplanes)
        self.dropout = Dropout(drop_ratio)
        self.fc = nn.Linear(inplanes * sp * sp, emb_size)
        self.bn_o2 = BatchNorm1d(emb_size)

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self.conv1, generator)
        xavier_uniform_(self.fc.weight, generator)
        with torch.no_grad():
            self.fc.bias.zero_()

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The stem and the four stages: the (N, C, H/32, W/32) map."""
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for i in (1, 2, 3, 4):
            x = getattr(self, f"layer{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(self.bn_o1(self.trunk(x)))
        return self.bn_o2(self.fc(torch.flatten(x, 1)))


def resnet50_pooled_features(model: ResNet, x: torch.Tensor) -> torch.Tensor:
    """The trunk's global-average-pooled features (2048-d for a bottleneck
    ResNet): torchvision's resnet50 without its fc, the MoCo feature
    path."""
    return model.trunk(x).mean(dim=(2, 3))


def ResNet_50(input_size=112, **kw):
    return ResNet(input_size, (3, 4, 6, 3), "bottleneck", **kw)


def ResNet_101(input_size=112, **kw):
    return ResNet(input_size, (3, 4, 23, 3), "bottleneck", **kw)


def ResNet_152(input_size=112, **kw):
    return ResNet(input_size, (3, 8, 36, 3), "bottleneck", **kw)
