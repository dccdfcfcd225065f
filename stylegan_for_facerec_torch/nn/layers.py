"""Layers of this slice that torch does not have as such."""

from __future__ import annotations

import torch
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
