"""The StyleGAN2 (rosinality) layer this slice needs: ``EqualLinear``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import normal_


class EqualLinear(nn.Module):
    """Equalized-learning-rate linear layer: weight (out, in) stored as
    N(0, 1) / lr_mul, scaled at run time by lr_mul / sqrt(in); bias scaled
    by lr_mul."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0):
        super().__init__()
        self.in_dim, self.lr_mul, self.bias_init = in_dim, lr_mul, bias_init
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = (nn.Parameter(torch.full((out_dim,), float(bias_init)))
                     if bias else None)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator, std=1.0 / self.lr_mul)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * (self.lr_mul / math.sqrt(self.in_dim))
        b = (self.bias.to(x.dtype) * self.lr_mul
             if self.bias is not None else None)
        return F.linear(x, w, b)
