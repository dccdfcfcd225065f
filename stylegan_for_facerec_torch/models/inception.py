"""InceptionV3 pool3 features for FID, NCHW, as
``stylegan_for_facerec_tpu/models/inception.py``.

Module names are torchvision's ``inception_v3`` names
(``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
...), so a torchvision or pytorch-fid ``state_dict`` loads strictly once
its ``fc.`` and ``AuxLogits.`` keys are dropped
(``utils.checkpoint.load_inception``), and ``utils.convert.from_jax``
fills the network from the JAX package's trees.

``fid_variant=True`` (default) is pytorch-fid's FIDInception network: the
in-block 3x3 stride-1 average pools leave the padding out of the divisor
(``count_include_pad=False``) and Mixed_7c's pool branch is a max pool.
``fid_variant=False`` is torchvision's network.

Input: (B, 3, H, W) in [-1, 1]; ``resize_input=True`` resizes it to
299 x 299 with ``ops.image.resize_bilinear`` (the JAX package's
interpolation matrices). Output: (B, 2048), the spatial mean of
Mixed_7c. The network launches none of the port's kernels: cuDNN
convolutions, BatchNorm in eval mode, pools.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import init_conv_xavier_
from ..ops.image import resize_bilinear

IntPair = Union[int, Tuple[int, int]]


class BasicConv2d(nn.Module):
    """Convolution without bias, BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntPair,
                 stride: IntPair = 1, padding: IntPair = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def init_weights_(self, generator: torch.Generator):
        """The JAX package's ``Conv2d`` init: xavier-uniform."""
        init_conv_xavier_(self.conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor, fid: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not fid)


def _chain(block: nn.Module, names: Sequence[str],
           x: torch.Tensor) -> torch.Tensor:
    for name in names:
        x = getattr(block, name)(x)
    return x


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, fid: bool = True):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1x1(x),
            _chain(self, ("branch5x5_1", "branch5x5_2"), x),
            _chain(self, ("branch3x3dbl_1", "branch3x3dbl_2",
                          "branch3x3dbl_3"), x),
            self.branch_pool(_avg3(x, self.fid))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch3x3(x),
            _chain(self, ("branch3x3dbl_1", "branch3x3dbl_2",
                          "branch3x3dbl_3"), x),
            F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int, fid: bool = True):
        super().__init__()
        self.fid = fid
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.branch1x1(x),
            _chain(self, ("branch7x7_1", "branch7x7_2", "branch7x7_3"), x),
            _chain(self, ("branch7x7dbl_1", "branch7x7dbl_2",
                          "branch7x7dbl_3", "branch7x7dbl_4",
                          "branch7x7dbl_5"), x),
            self.branch_pool(_avg3(x, self.fid))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            _chain(self, ("branch3x3_1", "branch3x3_2"), x),
            _chain(self, ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                          "branch7x7x3_4"), x),
            F.max_pool2d(x, 3, stride=2)], dim=1)


class InceptionE(nn.Module):
    """``pool="avg"``: torchvision's block and pytorch-fid's Mixed_7b;
    ``pool="max"``: pytorch-fid's Mixed_7c."""

    def __init__(self, in_ch: int, pool: str = "avg", fid: bool = True):
        super().__init__()
        self.pool, self.fid = pool, fid
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        bd = _chain(self, ("branch3x3dbl_1", "branch3x3dbl_2"), x)
        bp = (F.max_pool2d(x, 3, stride=1, padding=1) if self.pool == "max"
              else _avg3(x, self.fid))
        return torch.cat([
            self.branch1x1(x),
            self.branch3x3_2a(b3), self.branch3x3_2b(b3),
            self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd),
            self.branch_pool(bp)], dim=1)


class InceptionV3(nn.Module):
    """Pool3 (2048-d) InceptionV3 feature extractor; see the module
    docstring for the weights and the input."""

    def __init__(self, fid_variant: bool = True, resize_input: bool = True):
        super().__init__()
        f = fid_variant
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid=f)
        self.Mixed_5c = InceptionA(256, 64, fid=f)
        self.Mixed_5d = InceptionA(288, 64, fid=f)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid=f)
        self.Mixed_6c = InceptionC(768, 160, fid=f)
        self.Mixed_6d = InceptionC(768, 160, fid=f)
        self.Mixed_6e = InceptionC(768, 192, fid=f)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, pool="avg", fid=f)
        self.Mixed_7c = InceptionE(2048, pool="max" if f else "avg", fid=f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize_input:
            x = resize_bilinear(x, 299, 299)
        x = _chain(self, ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3"),
                   x)
        x = F.max_pool2d(x, 3, stride=2)
        x = _chain(self, ("Conv2d_3b_1x1", "Conv2d_4a_3x3"), x)
        x = F.max_pool2d(x, 3, stride=2)
        x = _chain(self, ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                          "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                          "Mixed_7a", "Mixed_7b", "Mixed_7c"), x)
        return x.mean(dim=(2, 3))
