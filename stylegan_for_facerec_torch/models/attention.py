"""Residual Attention Network backbone (NCHW), as
``stylegan_for_facerec_tpu/models/attention.py``: pre-activation bottleneck
residual blocks, hourglass attention masks gating the trunk by
(1 + sigmoid(mask)), align-corners bilinear upsampling, and a Flatten ->
Linear(2048 h w -> feat, no bias) -> BN1d head. Module names follow the
reference torch tree (``attention_body.1.softmax1_blocks``,
``output_layer.1``), which ``utils.convert.from_jax`` fills; the convs
take torch's default init, the embedding Linear xavier-uniform.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import init_conv_torch_default_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d, Flatten
from ..ops.image import resize_bilinear_align_corners


def _conv(ci, co, k=1, stride=1, padding=0):
    return nn.Conv2d(ci, co, k, stride=stride, padding=padding, bias=False)


class ResidualBlock(nn.Module):
    """BN -> ReLU (``out1``) -> conv1x1 -> BN -> ReLU -> conv3x3(stride) ->
    BN -> ReLU -> conv1x1, plus the input, or ``conv4`` of the
    pre-activation ``out1`` where the channels or the stride change.
    ``conv4`` exists (and is unused) otherwise, as in the reference."""

    def __init__(self, input_channels: int, output_channels: int,
                 stride: int = 1):
        super().__init__()
        ci, co = input_channels, output_channels
        self.bn1 = BatchNorm2d(ci)
        self.conv1 = _conv(ci, co // 4)
        self.bn2 = BatchNorm2d(co // 4)
        self.conv2 = _conv(co // 4, co // 4, 3, stride, 1)
        self.bn3 = BatchNorm2d(co // 4)
        self.conv3 = _conv(co // 4, co)
        self.conv4 = _conv(ci, co, 1, stride)
        self.project = ci != co or stride != 1

    def init_weights_(self, generator: torch.Generator):
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            init_conv_torch_default_(conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = torch.relu(self.bn1(x))
        out = torch.relu(self.bn2(self.conv1(out1)))
        out = torch.relu(self.bn3(self.conv2(out)))
        out = self.conv3(out)
        return out + (self.conv4(out1) if self.project else x)


class _MaskHead(nn.Sequential):
    """BN -> ReLU -> conv1x1 -> BN -> ReLU -> conv1x1 -> sigmoid."""

    def __init__(self, c: int):
        super().__init__(BatchNorm2d(c), nn.ReLU(), _conv(c, c),
                         BatchNorm2d(c), nn.ReLU(), _conv(c, c),
                         nn.Sigmoid())

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self[2], generator)
        init_conv_torch_default_(self[5], generator)


def _blocks(c: int, n: int) -> nn.Module:
    if n == 1:
        return ResidualBlock(c, c)
    return nn.Sequential(*[ResidualBlock(c, c) for _ in range(n)])


class AttentionModule(nn.Module):
    """Stages 1-3 in one: ``depth`` max-pool levels in the hourglass mask
    branch (stage 1: 3, stage 2: 2, stage 3: 1); output
    ``last_blocks((1 + mask) * trunk)``."""

    def __init__(self, channels: int, depth: int):
        super().__init__()
        if depth not in (1, 2, 3):
            raise ValueError(f"depth {depth}: 1|2|3")
        c, self.depth = channels, depth
        self.first_residual_blocks = ResidualBlock(c, c)
        self.trunk_branches = _blocks(c, 2)
        if depth == 3:
            self.softmax1_blocks = ResidualBlock(c, c)
            self.skip1_connection_residual_block = ResidualBlock(c, c)
            self.softmax2_blocks = ResidualBlock(c, c)
            self.skip2_connection_residual_block = ResidualBlock(c, c)
            self.softmax3_blocks = _blocks(c, 2)
            self.softmax4_blocks = ResidualBlock(c, c)
            self.softmax5_blocks = ResidualBlock(c, c)
            self.softmax6_blocks = _MaskHead(c)
        elif depth == 2:
            self.softmax1_blocks = ResidualBlock(c, c)
            self.skip1_connection_residual_block = ResidualBlock(c, c)
            self.softmax2_blocks = _blocks(c, 2)
            self.softmax3_blocks = ResidualBlock(c, c)
            self.softmax4_blocks = _MaskHead(c)
        else:
            self.softmax1_blocks = _blocks(c, 2)
            self.softmax2_blocks = _MaskHead(c)
        self.last_blocks = ResidualBlock(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def pool(h):
            return F.max_pool2d(h, 3, 2, padding=1)

        def up_to(h, ref):
            return resize_bilinear_align_corners(h, ref.shape[2],
                                                 ref.shape[3])

        x = self.first_residual_blocks(x)
        trunk = self.trunk_branches(x)
        if self.depth == 3:
            s1 = self.softmax1_blocks(pool(x))
            skip1 = self.skip1_connection_residual_block(s1)
            s2 = self.softmax2_blocks(pool(s1))
            skip2 = self.skip2_connection_residual_block(s2)
            s3 = self.softmax3_blocks(pool(s2))
            s4 = self.softmax4_blocks(up_to(s3, s2) + s2 + skip2)
            s5 = self.softmax5_blocks(up_to(s4, s1) + s1 + skip1)
            mask = self.softmax6_blocks(up_to(s5, trunk) + trunk)
        elif self.depth == 2:
            s1 = self.softmax1_blocks(pool(x))
            skip1 = self.skip1_connection_residual_block(s1)
            s2 = self.softmax2_blocks(pool(s1))
            s3 = self.softmax3_blocks(up_to(s2, s1) + s1 + skip1)
            mask = self.softmax4_blocks(up_to(s3, trunk) + trunk)
        else:
            s1 = self.softmax1_blocks(pool(x))
            mask = self.softmax2_blocks(up_to(s1, trunk) + trunk)
        return self.last_blocks((1 + mask) * trunk)


class ResidualAttentionNet(nn.Module):
    """conv7x7/2 + BN (``conv1``) -> ReLU -> ``attention_body`` -> Flatten
    -> Linear(2048 out_h out_w -> feat_dim, no bias) -> BN1d. At 112 px
    the body ends at 7 x 7."""

    def __init__(self, stage1_modules: int = 1, stage2_modules: int = 1,
                 stage3_modules: int = 1, feat_dim: int = 512,
                 out_h: int = 7, out_w: int = 7):
        super().__init__()
        self.conv1 = nn.Sequential(_conv(3, 64, 7, 2, 3), BatchNorm2d(64))
        body = [ResidualBlock(64, 256)]
        body += [AttentionModule(256, 3) for _ in range(stage1_modules)]
        body += [ResidualBlock(256, 512, 2)]
        body += [AttentionModule(512, 2) for _ in range(stage2_modules)]
        body += [ResidualBlock(512, 1024, 2)]
        body += [AttentionModule(1024, 1) for _ in range(stage3_modules)]
        body += [ResidualBlock(1024, 2048, 2), ResidualBlock(2048, 2048),
                 ResidualBlock(2048, 2048)]
        self.attention_body = nn.Sequential(*body)
        self.output_layer = nn.Sequential(
            Flatten((out_h, out_w)),
            nn.Linear(2048 * out_h * out_w, feat_dim, bias=False),
            BatchNorm1d(feat_dim))

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self.conv1[0], generator)
        xavier_uniform_(self.output_layer[1].weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.conv1(x))
        return self.output_layer(self.attention_body(x))


def AttentionNet_56(feat_dim=512, out_h=7, out_w=7):
    return ResidualAttentionNet(1, 1, 1, feat_dim, out_h, out_w)


def AttentionNet_92(feat_dim=512, out_h=7, out_w=7):
    return ResidualAttentionNet(1, 2, 3, feat_dim, out_h, out_w)
