"""IR / IR-SE ResNet blocks and face-recognition backbones (NCHW).

Module names follow the reference torch tree (``body.3.res_layer.1``,
``res_layer.5.fc1``, ``output_layer.3``), which ``utils.convert.from_jax``
fills. A backbone maps (N, C, 112, 112) images in [-1, 1] to (N, emb)
embeddings; ``l2_norm`` is left to the caller, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..nn.initializers import init_conv_xavier_, xavier_uniform_
from ..nn.layers import BatchNorm1d, BatchNorm2d, Dropout, Flatten, Subsample


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
    BN -> conv3x3 -> PReLU -> conv3x3(stride) -> BN [-> SE].

    ``dropout`` inserts Dropout after each 3x3 conv (``res_layer`` 1 and
    3) and after the conv shortcut; it owns no weights, so checkpoints
    move between blocks with and without it."""

    def __init__(self, in_channel: int, depth: int, stride: int,
                 se: bool = False, dropout: Optional[float] = None):
        super().__init__()
        if in_channel == depth:
            self.shortcut_layer = Subsample(stride)
        else:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(in_channel, depth, 1, stride=stride, bias=False),
                BatchNorm2d(depth))
        res = [BatchNorm2d(in_channel),
               nn.Conv2d(in_channel, depth, 3, padding=1, bias=False),
               nn.PReLU(depth),
               nn.Conv2d(depth, depth, 3, stride=stride, padding=1,
                         bias=False),
               BatchNorm2d(depth)]
        if se:
            res.append(SEModule(depth, 16))
        self.res_layer = nn.Sequential(*res)
        self.drop = Dropout(dropout) if dropout else None

    def init_weights_(self, generator: torch.Generator):
        convs = [self.res_layer[1], self.res_layer[3]]
        if isinstance(self.shortcut_layer, nn.Sequential):
            convs.append(self.shortcut_layer[0])
        for conv in convs:
            init_conv_xavier_(conv, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.shortcut_layer(x)
        if self.drop is None:
            return self.res_layer(x) + shortcut
        if isinstance(self.shortcut_layer, nn.Sequential):
            shortcut = self.drop(shortcut)
        h = x
        for i, layer in enumerate(self.res_layer):
            h = layer(h)
            if i in (1, 3):
                h = self.drop(h)
        return h + shortcut


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


def end_spatial(input_size: int) -> int:
    """Side of the body's last map: four stride-2 stages, each ceil(n/2)
    (112 -> 7, 224 -> 14)."""
    sp = input_size
    for _ in range(4):
        sp = -(-sp // 2)
    return sp


def facerec_output_layer(spatial: int, emb_size: int,
                         drop_ratio: float) -> nn.Sequential:
    """BN2d(512) -> Dropout -> Flatten -> Linear(512 s s, emb) -> BN1d."""
    return nn.Sequential(
        BatchNorm2d(512), Dropout(drop_ratio), Flatten((spatial, spatial)),
        nn.Linear(512 * spatial * spatial, emb_size), BatchNorm1d(emb_size))


@torch.no_grad()
def init_stem_and_head_(input_layer: nn.Sequential,
                        output_layer: nn.Sequential,
                        generator: torch.Generator):
    """The input conv and the embedding Linear: xavier-uniform, zero bias."""
    init_conv_xavier_(input_layer[0], generator)
    linear = output_layer[3]
    xavier_uniform_(linear.weight, generator)
    linear.bias.zero_()


class Backbone(nn.Module):
    """IR / IR-SE backbone: input_layer conv3x3 -> BN -> PReLU; the body's
    bottleneck units; output_layer BN2d -> Dropout(drop_ratio) -> Flatten
    -> Linear -> BN1d. ``in_channels=6`` takes the pSp image + average
    image input."""

    def __init__(self, input_size: int = 112, num_layers: int = 50,
                 mode: str = "ir", in_channels: int = 3, emb_size: int = 512,
                 drop_ratio: float = 0.5,
                 block_dropout: Optional[float] = None):
        super().__init__()
        if mode not in ("ir", "ir_se"):
            raise ValueError(f"mode {mode!r}: ir|ir_se")
        self.input_layer = nn.Sequential(
            nn.Conv2d(in_channels, 64, 3, padding=1, bias=False),
            BatchNorm2d(64), nn.PReLU(64))
        self.body = nn.Sequential(*[
            BottleneckIR(i, d, s, se=mode == "ir_se", dropout=block_dropout)
            for i, d, s in get_blocks(num_layers)])
        self.output_layer = facerec_output_layer(end_spatial(input_size),
                                                 emb_size, drop_ratio)

    def init_weights_(self, generator: torch.Generator):
        init_stem_and_head_(self.input_layer, self.output_layer, generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """input_layer + body only: the 512 x s x s feature map."""
        return self.body(self.input_layer(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_layer(self.features(x))


def IR_50(input_size=112, **kw):
    return Backbone(input_size, 50, "ir", **kw)


def IR_101(input_size=112, **kw):
    return Backbone(input_size, 100, "ir", **kw)


def IR_152(input_size=112, **kw):
    return Backbone(input_size, 152, "ir", **kw)


def IR_SE_50(input_size=112, **kw):
    return Backbone(input_size, 50, "ir_se", **kw)


def IR_SE_101(input_size=112, **kw):
    return Backbone(input_size, 100, "ir_se", **kw)


def IR_SE_152(input_size=112, **kw):
    return Backbone(input_size, 152, "ir_se", **kw)


def l2_norm(x: torch.Tensor, axis: int = 1, eps: float = 0.0) -> torch.Tensor:
    return x / (torch.linalg.norm(x, dim=axis, keepdim=True) + eps)
