"""Demographic-adaptive (GAC, race-aware) modules (NCHW), as
``stylegan_for_facerec_tpu/models/gac.py``:

  * ``Conv2dExtended``: a conv over the input concatenated with a one-hot
    demographic map;
  * ``AdaConv2dFaster``: per-group kernels ``kernel_base * kernel_mask[g]``,
    with the reference's quirk kept: groups 0 and 1 share kernel 0;
  * ``AdaConv2dGAC``: every group >= 1 has its own kernel, and the groups
    in ``fused_groups`` fall back to kernel 0 (the auto-fusing's result);
  * ``AttBlock``: a per-group channel gate, 2 sigmoid(a) ("ones" init:
    identity at init);
  * ``IRBlockGAC``, ``ResNetFaceGAC`` (6-channel 112 px input, pSp style
    heads on the last 7 x 7 map) and ``gac_resnet18`` ... ``152``.

The adaptive convs take the reference's form: the batch's rows are
grouped by label once a forward (``DemogGroups``: one host sync), and each
non-empty group's rows go through one conv with that group's kernel, then
back to their places. That is one conv's work over the batch; the JAX
package runs every group's conv over the whole batch and picks rows, G
times the work. Layouts, as the reference's: ``kernel_base`` (oc, ic, k,
k), ``kernel_mask`` (G, 1, ic, k, k), ``att_channel`` (G, 1, C, 1, 1).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import init_conv_xavier_, normal_
from ..nn.layers import BatchNorm2d
from .psp import GradualStyleBlock


class DemogGroups:
    """The rows of a batch grouped by demographic label: ``rows`` is
    [(label, row indices)] for each label present, in label order, and
    ``inverse`` puts the groups' concatenated rows back in batch order.
    Reading the group sizes is one host sync."""

    def __init__(self, labels: torch.Tensor, ndemog: int):
        labels = labels.long()
        self.labels = labels
        counts = torch.bincount(labels, minlength=ndemog).tolist()
        order = torch.argsort(labels, stable=True)
        self.rows, start = [], 0
        for label, n in enumerate(counts):
            if n:
                self.rows.append((label, order[start:start + n]))
            start += n
        self.inverse = torch.argsort(order)


Labels = Union[torch.Tensor, DemogGroups]


def _groups(labels: Labels, ndemog: int) -> DemogGroups:
    return labels if isinstance(labels, DemogGroups) else DemogGroups(
        labels, ndemog)


class Conv2dExtended(nn.Module):
    """conv(concat(x, one-hot(races) broadcast over H x W)); xavier-uniform
    weight, zero bias."""

    def __init__(self, n_demog: int, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 0):
        super().__init__()
        self.n_demog = n_demog
        self.conv = nn.Conv2d(in_channels + n_demog, out_channels,
                              kernel_size, stride=stride, padding=padding)

    def init_weights_(self, generator: torch.Generator):
        init_conv_xavier_(self.conv, generator)

    def forward(self, x: torch.Tensor, races: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        demog = F.one_hot(races.long(), self.n_demog).to(x.dtype)
        demog = demog[:, :, None, None].expand(n, self.n_demog, h, w)
        return self.conv(torch.cat([x, demog], dim=1))


class AdaConv2dFaster(nn.Module):
    """Group g's kernel is ``kernel_base * kernel_mask[k(g)]`` with k(g) =
    g for g > 1 and 0 for groups 0 and 1 (the reference's loop guard).
    Without ``adap`` one conv with ``kernel_base``. No bias. Init
    xavier-normal; the mask's fan-out counts its G groups, since the
    reference repeats the mask before drawing it."""

    def __init__(self, ndemog: int, ic: int, oc: int, ks: int,
                 stride: int = 1, padding: int = 0, adap: bool = True):
        super().__init__()
        self.ndemog, self.stride, self.padding, self.adap = (
            ndemog, stride, padding, adap)
        g = ndemog if adap else 1
        self.kernel_base = nn.Parameter(torch.empty(oc, ic, ks, ks))
        self.kernel_mask = nn.Parameter(torch.empty(g, 1, ic, ks, ks))

    def init_weights_(self, generator: torch.Generator):
        oc, ic, k, _ = self.kernel_base.shape
        g, rf = self.kernel_mask.shape[0], k * k
        normal_(self.kernel_base, generator,
                std=math.sqrt(2.0 / (ic * rf + oc * rf)))
        normal_(self.kernel_mask, generator,
                std=math.sqrt(2.0 / (ic * rf + g * rf)))

    def kernel_for(self, label: int) -> int:
        return label if label > 1 else 0

    def forward(self, x: torch.Tensor, labels: Labels) -> torch.Tensor:
        base = self.kernel_base.to(x.dtype)
        if not self.adap:
            return F.conv2d(x, base, stride=self.stride, padding=self.padding)
        kernels = base[None] * self.kernel_mask.to(x.dtype)
        groups = _groups(labels, self.ndemog)
        ys = [F.conv2d(x.index_select(0, idx), kernels[self.kernel_for(l)],
                       stride=self.stride, padding=self.padding)
              for l, idx in groups.rows]
        return torch.cat(ys)[groups.inverse]


class AdaConv2dGAC(AdaConv2dFaster):
    """Every group >= 1 has its own kernel (the guard ``i >= 1``); a group
    in ``fused_groups`` uses kernel 0 (``fuse_epoch``: when the
    reference's auto-fusing starts; kept as an attribute)."""

    def __init__(self, ndemog: int, ic: int, oc: int, ks: int,
                 stride: int = 1, padding: int = 0, adap: bool = True,
                 fuse_epoch: int = 9, fused_groups: Tuple[int, ...] = ()):
        super().__init__(ndemog, ic, oc, ks, stride, padding, adap)
        self.fuse_epoch = fuse_epoch
        self.fused_groups = tuple(fused_groups)

    def kernel_for(self, label: int) -> int:
        return 0 if label in self.fused_groups else label


class AttBlock(nn.Module):
    """x times the sample's group gate sigmoid(att_channel[g]) (times 2 with
    the "ones" init, whose zeros make the gate 1)."""

    def __init__(self, nchannel: int, ndemog: int = 4,
                 init_strategy: str = "ones"):
        super().__init__()
        self.ndemog, self.init_strategy = ndemog, init_strategy
        self.att_channel = nn.Parameter(torch.zeros(ndemog, 1, nchannel, 1,
                                                    1))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        if self.init_strategy != "xavier":
            self.att_channel.zero_()
            return
        c = self.att_channel.shape[2]
        a = math.sqrt(6.0 / (2 * c))
        one = torch.empty(1, 1, c, 1, 1).uniform_(-a, a, generator=generator)
        self.att_channel.copy_(one.expand_as(self.att_channel))

    def forward(self, x: torch.Tensor, labels: Labels) -> torch.Tensor:
        if isinstance(labels, DemogGroups):
            labels = labels.labels
        att = torch.sigmoid(self.att_channel.to(x.dtype))
        if self.init_strategy == "ones":
            att = att * 2
        return x * att[labels.long(), 0]


class IRBlockGAC(nn.Module):
    """BN -> adaptive conv3x3(stride) -> BN -> PReLU -> adaptive conv3x3
    -> BN, plus the input or a conv1x1(stride) + BN; PReLU; then the
    attention gate when ``use_att``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 ndemog: int = 4, adap: bool = False, use_att: bool = False):
        super().__init__()
        self.bn0 = BatchNorm2d(inplanes)
        self.conv1 = AdaConv2dGAC(ndemog, inplanes, planes, 3, stride, 1,
                                  adap=adap)
        self.bn1 = BatchNorm2d(planes)
        self.prelu1 = nn.PReLU(planes)
        self.conv2 = AdaConv2dGAC(ndemog, planes, planes, 3, 1, 1, adap=adap)
        self.bn2 = BatchNorm2d(planes)
        self.prelu2 = nn.PReLU(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False),
                BatchNorm2d(planes))
        self.att = AttBlock(planes, ndemog) if use_att else None
        self.ndemog = ndemog

    def init_weights_(self, generator: torch.Generator):
        if self.downsample is not None:
            init_conv_xavier_(self.downsample[0], generator)

    def forward(self, x: torch.Tensor, labels: Labels) -> torch.Tensor:
        groups = _groups(labels, self.ndemog)
        out = self.prelu1(self.bn1(self.conv1(self.bn0(x), groups)))
        out = self.bn2(self.conv2(out, groups))
        residual = x if self.downsample is None else self.downsample(x)
        out = self.prelu2(out + residual)
        if self.att is not None:
            out = self.att(out, groups)
        return out


class ResNetFaceGAC(nn.Module):
    """(N, in_channels, 112, 112) images and (N,) labels -> (N, n_styles,
    512) codes: conv3x3 -> BN -> PReLU -> maxpool2 -> four stages of
    ``IRBlockGAC`` -> BN (``bn4``) -> ``n_styles`` map2style heads (spatial
    16: four stride-2 convs take 7 x 7 to 1 x 1)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), ndemog: int = 4,
                 n_styles: int = 18, adap: bool = False,
                 use_att: bool = False, in_channels: int = 6):
        super().__init__()
        self.ndemog = ndemog
        self.conv1 = nn.Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.prelu = nn.PReLU(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers), 1):
            stride = 1 if li == 1 else 2
            units = []
            for b in range(blocks):
                units.append(IRBlockGAC(inplanes, planes,
                                        stride if b == 0 else 1, ndemog,
                                        adap, use_att))
                inplanes = planes
            setattr(self, f"layer{li}", nn.ModuleList(units))
        self.bn4 = BatchNorm2d(512)
        self.styles = nn.ModuleList([GradualStyleBlock(512, 512, 16)
                                     for _ in range(n_styles)])

    def init_weights_(self, generator: torch.Generator):
        init_conv_xavier_(self.conv1, generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        groups = DemogGroups(labels, self.ndemog)
        x = self.prelu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 2, 2)
        for li in (1, 2, 3, 4):
            for block in getattr(self, f"layer{li}"):
                x = block(x, groups)
        x = self.bn4(x)
        return torch.stack([s(x) for s in self.styles], dim=1)


def gac_resnet18(**kw):
    return ResNetFaceGAC(layers=(2, 2, 2, 2), **kw)


def gac_resnet34(**kw):
    return ResNetFaceGAC(layers=(3, 4, 6, 3), **kw)


def gac_resnet50(**kw):
    return ResNetFaceGAC(layers=(3, 4, 14, 3), **kw)


def gac_resnet100(**kw):
    return ResNetFaceGAC(layers=(3, 13, 30, 3), **kw)


def gac_resnet152(**kw):
    return ResNetFaceGAC(layers=(3, 8, 36, 3), **kw)
