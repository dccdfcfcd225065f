"""StyleGAN2 (rosinality) layers, NCHW: ``EqualLinear`` (the pSp heads and
the discriminator's head) and the discriminator of stage-1 training
(``stylegan_for_facerec_tpu/models/stylegan2.py``): ``EqualConv2d``,
``Blur``, ``Downsample``, ``ConvLayer``, ``ResBlock`` and
``Discriminator`` with its minibatch standard deviation.

Module and child names are the reference's torch names (``convs.{i}``,
``final_conv``, ``final_linear.{0,1}``; a ``ConvLayer``'s children ``0``
blur, ``1`` conv, ``2`` activation when it downsamples, else ``0`` conv,
``1`` activation), so ``utils.convert.from_jax`` fills them. The blur
kernels are numpy constants, not weights.

The activations are ``ops.fused_act.fused_leaky_relu`` (kernel B1, its
gradient B1b); the blurs are ``ops.upfirdn2d`` (depthwise convolutions).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import normal_
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import make_resample_kernel, upfirdn2d


class EqualLinear(nn.Module):
    """Equalized-learning-rate linear layer: weight (out, in) stored as
    N(0, 1) / lr_mul, scaled at run time by lr_mul / sqrt(in); bias scaled
    by lr_mul. ``activation="fused_lrelu"`` adds the bias through
    ``fused_leaky_relu``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 bias_init: float = 0.0, lr_mul: float = 1.0,
                 activation: Optional[str] = None):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"activation {activation!r}: None|fused_lrelu")
        self.in_dim, self.lr_mul, self.bias_init = in_dim, lr_mul, bias_init
        self.activation = activation
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
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(F.linear(x, w), b)
        return F.linear(x, w, b)


class EqualConv2d(nn.Module):
    """Equalized-learning-rate convolution: weight (O, I, k, k) stored as
    N(0, 1), scaled at run time by 1 / sqrt(I k^2)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.zeros(out_channel, in_channel,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype) * self.scale, b,
                        stride=self.stride, padding=self.padding)


class Blur(nn.Module):
    """``upfirdn2d`` with the normalised outer-product kernel (times
    ``upsample_factor^2``) and ``pad``."""

    def __init__(self, kernel: Sequence[int], pad, upsample_factor: int = 1):
        super().__init__()
        k = make_resample_kernel(kernel)
        if upsample_factor > 1:
            k = k * upsample_factor ** 2
        self.kernel, self.pad = k, tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Downsample(nn.Module):
    """Blur and keep every ``factor``-th sample."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        k = make_resample_kernel(kernel)
        p = k.shape[0] - factor
        self.kernel, self.factor = k, factor
        self.pad = ((p + 1) // 2, p // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, down=self.factor, pad=self.pad)


class FusedLeakyReLU(nn.Module):
    """``fused_leaky_relu`` with a learned bias (zeros at init)."""

    def __init__(self, channel: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)


class ScaledLeakyReLU(nn.Module):
    """``fused_leaky_relu`` without a bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x)


class ConvLayer(nn.Sequential):
    """Optional blur + stride-2 downsample, equalized conv, activation.
    The conv has its own bias only when there is no activation."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 bias: bool = True, activate: bool = True):
        layers = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, ((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(EqualConv2d(in_channel, out_channel, kernel_size,
                                  stride=stride, padding=padding,
                                  bias=bias and not activate))
        if activate:
            layers.append(FusedLeakyReLU(out_channel) if bias
                          else ScaledLeakyReLU())
        super().__init__(*layers)


class ResBlock(nn.Module):
    """conv 3x3, conv 3x3 downsampling, 1x1 downsampling skip; the sum over
    sqrt(2)."""

    def __init__(self, in_channel: int, out_channel: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True,
                               blur_kernel=blur_kernel)
        self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True,
                              blur_kernel=blur_kernel, activate=False,
                              bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2)


def discriminator_channels(channel_multiplier: int = 2):
    return {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}


class Discriminator(nn.Module):
    """1x1 from-RGB conv, ResBlocks down to 4x4, minibatch standard
    deviation (one feature over groups of min(N, 4)), 3x3 conv, then
    ``final_linear``: EqualLinear(C*16, C) with fused lrelu and
    EqualLinear(C, 1). Returns (N, 1) logits."""

    def __init__(self, size: int = 256, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 stddev_group: int = 4, stddev_feat: int = 1):
        super().__init__()
        ch = discriminator_channels(channel_multiplier)
        self.size = size
        self.stddev_group, self.stddev_feat = stddev_group, stddev_feat
        layers = [ConvLayer(3, ch[size], 1)]
        in_ch = ch[size]
        for i in range(int(math.log2(size)), 2, -1):
            out_ch = ch[2 ** (i - 1)]
            layers.append(ResBlock(in_ch, out_ch, blur_kernel))
            in_ch = out_ch
        self.convs = nn.Sequential(*layers)
        self.final_conv = ConvLayer(in_ch + 1, ch[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(ch[4] * 4 * 4, ch[4], activation="fused_lrelu"),
            EqualLinear(ch[4], 1))

    def minibatch_stddev(self, x: torch.Tensor) -> torch.Tensor:
        """Append the feature: sample j of each group of M = N / group
        consecutive groups is compared with samples j, j + M, ... (the
        reference's ``view(group, -1, ...)``)."""
        n, c, h, w = x.shape
        group, f = min(n, self.stddev_group), self.stddev_feat
        y = x.reshape(group, -1, f, c // f, h, w)
        y = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
        y = y.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        return torch.cat([x, y.repeat(group, 1, h, w)], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_conv(self.minibatch_stddev(self.convs(x)))
        return self.final_linear(x.flatten(1))
