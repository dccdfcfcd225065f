"""Layers that torch does not have as such: the IR block's strided
shortcut, a dropout that draws from an explicit generator, a Flatten that
knows the map it flattens, and BatchNorm with per-group ("ghost")
statistics."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Subsample(nn.Module):
    """Strided subsampling, torch ``MaxPool2d(kernel_size=1, stride)``: the
    IR block's identity shortcut."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        return x[:, :, ::s, ::s]


class Dropout(nn.Dropout):
    """Inverted dropout, active only in train mode: a kept element is
    divided by 1 - p. The mask is drawn from ``generator`` (a
    ``torch.Generator`` on the input's device, which the trainer sets);
    drawing one without it raises, so no draw comes from a global
    generator."""

    generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise ValueError("Dropout in train mode draws its mask from an "
                             "explicit torch.Generator: set .generator")
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


class Flatten(nn.Flatten):
    """(N, C, H, W) -> (N, C*H*W), torch's (C, H, W) order. ``hw`` is the
    (H, W) of the map: the JAX package flattens NHWC as (H, W, C), and
    ``utils.convert.from_jax`` permutes the next Linear's input axis with
    it."""

    def __init__(self, hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.hw = None if hw is None else tuple(hw)


class _GhostBatchNorm:
    """torch BatchNorm, or with ``bn_groups`` > 1 in train mode ghost
    BatchNorm: the batch splits into ``bn_groups`` contiguous groups, each
    normalized with its own statistics, and only group 0's update the
    running statistics (DataParallel's per-replica BatchNorm, where the
    first replica's buffers are the module's)."""

    bn_groups: Optional[int] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        groups = self.bn_groups
        if not self.training or not groups or groups <= 1:
            return super().forward(x)
        if x.shape[0] % groups:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{groups} BatchNorm groups")
        parts = x.chunk(groups)
        out = [super().forward(parts[0])]
        out += [F.batch_norm(p, None, None, self.weight, self.bias, True,
                             0.0, self.eps) for p in parts[1:]]
        return torch.cat(out)


class BatchNorm2d(_GhostBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm1d(_GhostBatchNorm, nn.BatchNorm1d):
    pass
