"""StyleGAN2 (rosinality) layers, NCHW: ``EqualLinear`` (the pSp heads and
the discriminator's head), the generator and the discriminator of stage-1
training (``stylegan_for_facerec_tpu/models/stylegan2.py``).

The generator: ``pixel_norm``, ``Upsample``, ``ModulatedConv2d`` in the
scaled-activation form (one shared-weight convolution; upsampling is a
stride-2 transposed convolution followed by a blur, downsampling a blur
followed by a stride-2 convolution; the demodulation coefficients in f32),
``NoiseInjection``, ``StyledConv``, ``ToRGB`` and ``Generator`` with its
8-layer style MLP, const input, per-layer noise buffers, style mixing and
truncation. The discriminator: ``EqualConv2d``, ``Blur``, ``Downsample``,
``ConvLayer``, ``ResBlock`` and ``Discriminator`` with its minibatch
standard deviation.

Module and child names are the reference's torch names (``style.{1..8}``,
``input.input``, ``convs.{i}``, ``to_rgbs.{i}``, ``noises.noise_{i}``,
``final_conv``, ``final_linear.{0,1}``; a ``ConvLayer``'s children ``0``
blur, ``1`` conv, ``2`` activation when it downsamples, else ``0`` conv,
``1`` activation), so ``utils.convert.from_jax`` fills them. The blur
kernels are numpy constants, not weights.

The activations are ``ops.fused_act.fused_leaky_relu`` (kernel B1, its
gradient B1b); the blurs and the image skip's upsampling are
``ops.upfirdn2d`` (zero insertion and depthwise convolutions; kernel B2
computes another function, the nearest-neighbour smooth upsample).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import normal_
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import make_resample_kernel, upfirdn2d


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x over the root mean square of its dim 1 (the channels)."""
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


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


class Upsample(nn.Module):
    """Zero-insertion ``factor``x upsample with the blur kernel (times
    factor^2), pad ((p + 1) // 2 + factor - 1, p // 2)."""

    def __init__(self, kernel: Sequence[int] = (1, 3, 3, 1), factor: int = 2):
        super().__init__()
        k = make_resample_kernel(kernel) * factor ** 2
        p = k.shape[0] - factor
        self.kernel, self.factor = k, factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, up=self.factor, pad=self.pad)


def _mod_demod(weight: torch.Tensor, styles: torch.Tensor, scale: float,
               eps: float = 1e-8) -> torch.Tensor:
    """(N, O) demodulation coefficients of the shared-weight form,
    rsqrt(sum_ik (scale W[o, i, k] style[n, i])^2 + eps), in f32 from the
    f32 weight (f64 for an f64 weight), autocast or not."""
    ct = torch.promote_types(weight.dtype, torch.float32)
    with torch.autocast(styles.device.type, enabled=False):
        w_sq = (weight.to(ct).square() * scale * scale).sum(dim=(2, 3))
        return torch.rsqrt(styles.to(ct).square() @ w_sq.t() + eps)


class ModulatedConv2d(nn.Module):
    """Style-modulated convolution, weight (1, O, I, k, k) stored as N(0, 1)
    and scaled by 1 / sqrt(I k^2) at run time; ``modulation`` (an
    ``EqualLinear``, bias 1) maps the style to the input scales. The
    activations are scaled per sample and one shared-weight convolution
    follows, then the demodulation. ``upsample``: stride-2 transposed
    convolution, demodulation, ``Blur`` (kernel x4, pad (1, 1) for k = 3);
    ``downsample``: ``Blur`` then a stride-2 convolution; else a pad-k//2
    convolution."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, demodulate: bool = True,
                 upsample: bool = False, downsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.kernel_size = kernel_size
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size ** 2)
        self.demodulate, self.upsample = demodulate, upsample
        self.downsample = downsample
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.weight = nn.Parameter(torch.zeros(1, out_channel, in_channel,
                                               kernel_size, kernel_size))
        k = kernel_size
        if upsample:
            p = (len(blur_kernel) - 2) - (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2 + 1, p // 2 + 1),
                             upsample_factor=2)
        elif downsample:
            p = (len(blur_kernel) - 2) + (k - 1)
            self.blur = Blur(blur_kernel, ((p + 1) // 2, p // 2))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator)

    def _demod(self, y, styles):
        if not self.demodulate:
            return y
        d = _mod_demod(self.weight[0], styles, self.scale)
        return y * d.to(y.dtype)[:, :, None, None]

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        styles = self.modulation(style)
        w = self.weight[0].to(x.dtype) * self.scale
        x = x * styles.to(x.dtype)[:, :, None, None]
        if self.upsample:
            # (O, I, k, k) -> the transposed convolution's (I, O, k, k)
            y = F.conv_transpose2d(x, w.transpose(0, 1), stride=2)
            return self.blur(self._demod(y, styles))
        if self.downsample:
            return self._demod(F.conv2d(self.blur(x), w, stride=2), styles)
        return self._demod(F.conv2d(x, w, padding=self.kernel_size // 2),
                           styles)


class NoiseInjection(nn.Module):
    """image + weight * noise; the (N, 1, H, W) noise is given, or drawn
    from ``generator`` (raising without one)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, image: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise is None:
            if generator is None:
                raise ValueError("NoiseInjection draws its noise from an "
                                 "explicit torch.Generator, or takes it "
                                 "given")
            n, _, h, w = image.shape
            noise = torch.randn((n, 1, h, w), generator=generator,
                                device=image.device, dtype=image.dtype)
        return image + self.weight.to(image.dtype) * noise.to(image.dtype)


class StyledConv(nn.Module):
    """``ModulatedConv2d`` -> ``NoiseInjection`` -> ``FusedLeakyReLU`` with
    its bias (kernels B1 and B1b)."""

    def __init__(self, in_channel: int, out_channel: int, kernel_size: int,
                 style_dim: int, upsample: bool = False,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 demodulate: bool = True):
        super().__init__()
        self.conv = ModulatedConv2d(in_channel, out_channel, kernel_size,
                                    style_dim, demodulate=demodulate,
                                    upsample=upsample,
                                    blur_kernel=blur_kernel)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)

    def forward(self, x, style, noise=None, generator=None):
        return self.activate(self.noise(self.conv(x, style), noise,
                                        generator))


class ToRGB(nn.Module):
    """Non-demodulated 1x1 ``ModulatedConv2d`` to 3 channels plus a bias
    (1, 3, 1, 1); the skip image, when given, is ``Upsample``d and
    added."""

    def __init__(self, in_channel: int, style_dim: int,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1)):
        super().__init__()
        self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim,
                                    demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        y = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            y = y + self.upsample(skip)
        return y


class ConstantInput(nn.Module):
    """The learned (1, C, size, size) input, repeated over the batch."""

    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.zeros(1, channel, size, size))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.input, generator)

    def forward(self, batch: int, dtype: torch.dtype) -> torch.Tensor:
        return self.input.to(dtype).repeat(batch, 1, 1, 1)


class _Noises(nn.Module):
    """The per-layer const noise buffers ``noise_{i}``, (1, 1, r, r)."""

    def __init__(self, num_layers: int):
        super().__init__()
        for i in range(num_layers):
            r = 2 ** ((i + 5) // 2)
            self.register_buffer(f"noise_{i}", torch.zeros(1, 1, r, r))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        for b in self.buffers():
            normal_(b, generator)


class Generator(nn.Module):
    """The rosinality StyleGAN2 generator: ``style`` (pixel norm, then
    ``n_mlp`` ``EqualLinear``s with lr_mul ``lr_mlp`` and fused lrelu),
    the const input, ``conv1``/``to_rgb1`` at 4x4 and per resolution an
    upsampling and a plain ``StyledConv`` and a ``ToRGB`` that adds the
    upsampled skip image.

    ``forward(styles, ...)`` takes one (N, style_dim) tensor or a list of
    them (z, or w with ``input_is_latent``; a single (N, n_latent, D)
    tensor of w's also). Two styles mix: latents before ``inject_index``
    come from the first, the rest from the second; without an index the
    crossover is drawn from ``generator`` in [1, n_latent). Truncation
    < 1 moves each style toward ``truncation_latent``. ``noise`` is one
    tensor per layer; without it, ``randomize_noise`` draws every layer's
    (N, 1, H, W) noise from ``generator``, else the ``noises`` buffers
    serve. Returns the NCHW image, and the (N, n_latent, D) latents with
    ``return_latents``."""

    def __init__(self, size: int = 256, style_dim: int = 512,
                 n_mlp: int = 8, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 lr_mlp: float = 0.01):
        super().__init__()
        self.size, self.style_dim = size, style_dim
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2
        ch = rosinality_channels(channel_multiplier)
        self.style = nn.Sequential(PixelNorm(), *(
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp,
                        activation="fused_lrelu") for _ in range(n_mlp)))
        self.input = ConstantInput(ch[4])
        self.conv1 = StyledConv(ch[4], ch[4], 3, style_dim,
                                blur_kernel=blur_kernel)
        self.to_rgb1 = ToRGB(ch[4], style_dim)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_ch = ch[4]
        for i in range(3, self.log_size + 1):
            out_ch = ch[2 ** i]
            self.convs.append(StyledConv(in_ch, out_ch, 3, style_dim,
                                         upsample=True,
                                         blur_kernel=blur_kernel))
            self.convs.append(StyledConv(out_ch, out_ch, 3, style_dim,
                                         blur_kernel=blur_kernel))
            self.to_rgbs.append(ToRGB(out_ch, style_dim,
                                      blur_kernel=blur_kernel))
            in_ch = out_ch
        self.noises = _Noises(self.num_layers)

    def style_mlp(self, z: torch.Tensor) -> torch.Tensor:
        """z (N, style_dim) -> w: pixel norm, then the MLP."""
        return self.style(z)

    @torch.no_grad()
    def mean_latent(self, n_latent: int,
                    generator: torch.Generator) -> torch.Tensor:
        """(1, style_dim): the mean w of ``n_latent`` z drawn from
        ``generator`` (on the generator's device)."""
        z = torch.randn((n_latent, self.style_dim), generator=generator,
                        device=self.input.input.device)
        return self.style_mlp(z).mean(dim=0, keepdim=True)

    def latents(self, styles: Union[torch.Tensor, List[torch.Tensor]],
                inject_index: Optional[int] = None,
                truncation: float = 1.0,
                truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """The (N, n_latent, D) latents ``forward`` synthesises from:
        the style MLP, truncation and style mixing."""
        if not isinstance(styles, (list, tuple)):
            styles = [styles]
        if not input_is_latent:
            styles = [self.style_mlp(s) for s in styles]
        if truncation < 1:
            styles = [truncation_latent + truncation * (s - truncation_latent)
                      for s in styles]
        if len(styles) < 2:
            latent = (styles[0] if styles[0].dim() == 3 else
                      styles[0][:, None].repeat(1, self.n_latent, 1))
        else:
            idx = inject_index
            if idx is None:
                if generator is None:
                    raise ValueError("style mixing without inject_index "
                                     "draws the crossover from an explicit "
                                     "torch.Generator")
                idx = int(torch.randint(1, self.n_latent, (),
                                        generator=generator,
                                        device=generator.device))
            pos = torch.arange(self.n_latent, device=styles[0].device)
            latent = torch.where(pos[None, :, None] < idx,
                                 styles[0][:, None, :], styles[1][:, None, :])
        return latent

    def forward(self, styles: Union[torch.Tensor, List[torch.Tensor]],
                return_latents: bool = False,
                inject_index: Optional[int] = None,
                truncation: float = 1.0,
                truncation_latent: Optional[torch.Tensor] = None,
                input_is_latent: bool = False,
                noise: Optional[List[torch.Tensor]] = None,
                randomize_noise: bool = True,
                generator: Optional[torch.Generator] = None):
        latent = self.latents(styles, inject_index, truncation,
                              truncation_latent, input_is_latent, generator)
        if noise is None:
            noise = ([None] * self.num_layers if randomize_noise else
                     [getattr(self.noises, f"noise_{i}")
                      for i in range(self.num_layers)])
        out = self.input(latent.shape[0], latent.dtype)
        out = self.conv1(out, latent[:, 0], noise[0], generator)
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for b, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * b](out, latent[:, i], noise[1 + 2 * b],
                                    generator)
            out = self.convs[2 * b + 1](out, latent[:, i + 1],
                                        noise[2 + 2 * b], generator)
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        if return_latents:
            return skip, latent
        return skip


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


def rosinality_channels(channel_multiplier: int = 2):
    """{resolution: channels} of the rosinality G and D."""
    return {4: 512, 8: 512, 16: 512, 32: 512,
            64: 256 * channel_multiplier, 128: 128 * channel_multiplier,
            256: 64 * channel_multiplier, 512: 32 * channel_multiplier,
            1024: 16 * channel_multiplier}


class Discriminator(nn.Module):
    """1x1 from-RGB conv, ResBlocks down to 4x4, minibatch standard
    deviation (one feature over groups of min(N, 4)), 3x3 conv, then
    ``final_linear``: EqualLinear(C*16, C) with fused lrelu and
    EqualLinear(C, 1). Returns (N, 1) logits."""

    batch_axis = None

    def __init__(self, size: int = 256, channel_multiplier: int = 2,
                 blur_kernel: Sequence[int] = (1, 3, 3, 1),
                 stddev_group: int = 4, stddev_feat: int = 1):
        super().__init__()
        ch = rosinality_channels(channel_multiplier)
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
        reference's ``view(group, -1, ...)``). Under data parallelism
        ``batch_axis`` (a ``parallel.mesh.Axis``) gathers the global batch
        with autograd, so the groups stride across it as on one device,
        and the rank keeps its rows of the feature."""
        xs = x if self.batch_axis is None else self.batch_axis.gather(x)
        n, c, h, w = xs.shape
        group, f = min(n, self.stddev_group), self.stddev_feat
        y = xs.reshape(group, -1, f, c // f, h, w)
        y = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
        y = y.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)
        y = y.repeat(group, 1, h, w)
        if self.batch_axis is not None:
            y = self.batch_axis.local(y)
        return torch.cat([x, y], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_conv(self.minibatch_stddev(self.convs(x)))
        return self.final_linear(x.flatten(1))
