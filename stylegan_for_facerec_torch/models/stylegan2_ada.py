"""StyleGAN2-ADA generator (NCHW): mapping network and synthesis pyramid.

Every ``SynthesisLayer`` runs modulated conv -> smooth 2x upsample (kernel
B2 on the card) -> noise -> bias + lrelu + gain + clamp (kernel B1 on the
card); every block upsamples its image skip with B2 too. ``noise_mode`` is
"const" (the stored buffers, the inversion path), "none", or "random",
which draws from an explicit ``torch.Generator`` or takes given ``noises``
(one (N, 1, res, res) tensor per synthesis layer, in forward order, as
stage-1 training gathers its draws).

The mapping network tracks ``w_avg`` in train mode and applies the
truncation trick, as ``stylegan_for_facerec_tpu/models/stylegan2_ada.py``.

``synthesis_layer="stylegan1"`` builds the StyleGAN1 layer family in
place of the modulated one: ``SynthesisLayer1`` (equalized conv -> smooth
upsample (B2) -> noise -> bias + lrelu + clamp (B1) -> ``AdaIN`` with the
affine of w split into gamma and beta) and ``ToRGBLayer1`` (a style-free
1x1 conv). ``EqualizedConv2d`` is the equalized conv with optional smooth
resampling and ``clamp_gain`` that the JAX package keeps beside them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import normal_
from ..nn.layers import InstanceNorm2d
from ..ops.fused_act import bias_act
from ..ops.modconv import modulated_conv2d
from ..ops.resample import smooth_downsample, smooth_upsample
from ..utils.quantize import active_hook

_NOISE_MODES = ("const", "none", "random")
_SYNTHESIS_LAYERS = ("stylegan2", "stylegan1")


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1,
                         eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnectedLayer(nn.Module):
    """Equalized-learning-rate dense layer: weight (out, in) stored as
    N(0, 1) / lr_multiplier, run-time gain lr_multiplier / sqrt(in);
    optional lrelu with sqrt(2) gain."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, activation: str = "linear",
                 lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.in_features = in_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = (nn.Parameter(torch.full((out_features,),
                                             float(bias_init)))
                     if bias else None)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator, std=1.0 / self.lr_multiplier)
        if self.bias is not None:
            self.bias.fill_(self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gain = self.lr_multiplier / math.sqrt(self.in_features)
        w = self.weight.to(x.dtype) * gain
        b = None
        if self.bias is not None:
            b = self.bias.to(x.dtype)
            if self.lr_multiplier != 1.0:
                b = b * self.lr_multiplier
        y = F.linear(x, w, b)
        if self.activation == "lrelu":
            y = torch.where(y >= 0, y, 0.2 * y) * math.sqrt(2)
        return y


class EqualizedConv2d(nn.Module):
    """Equalized conv: weight (O, I, k, k) stored as N(0, 1), run-time gain
    1 / sqrt(I k^2); ``resample`` "up" (smooth 2x upsample, kernel B2),
    "down" (``smooth_downsample``) or "none" before a pad-k//2 conv; then
    ``clamp_gain(act(x + b), act_gain * gain, 256 * gain)``, which is
    ``bias_act`` (kernel B1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = "linear",
                 resample: str = "none"):
        super().__init__()
        if resample not in ("none", "up", "down"):
            raise ValueError(f"resample {resample!r}: none|up|down")
        if activation not in ("linear", "lrelu"):
            raise ValueError(f"activation {activation!r}: linear|lrelu")
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.kernel_size = kernel_size
        self.activation, self.resample = activation, resample
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = self.weight.to(x.dtype) * self.weight_gain
        if self.resample == "up":
            x = smooth_upsample(x)
        elif self.resample == "down":
            x = smooth_downsample(x)
        y = F.conv2d(x, w, padding=self.kernel_size // 2)
        return bias_act(y, self.bias, act=self.activation, gain=gain,
                        clamp=256.0)


class MappingNetwork(nn.Module):
    """z -> w: 2nd-moment normalisation, ``num_layers`` equalized FCs (lrelu,
    lr_mul 0.01), broadcast to ``num_ws``, truncation toward ``w_avg``.

    In train mode each forward moves the ``w_avg`` buffer toward the
    batch's mean w (detached), ``w_avg = mean + beta (w_avg - mean)``,
    unless ``skip_w_avg_update``; ``w_avg_beta=None`` tracks no
    ``w_avg``, and truncation then raises."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512, num_ws: int = 18,
                 num_layers: int = 8, lr_multiplier: float = 0.01,
                 w_avg_beta: Optional[float] = 0.995):
        super().__init__()
        self.num_ws = num_ws
        self.w_avg_beta = w_avg_beta
        feats = [z_dim] + [w_dim] * num_layers
        self.layers = nn.ModuleList(
            FullyConnectedLayer(feats[i], feats[i + 1], activation="lrelu",
                                lr_multiplier=lr_multiplier)
            for i in range(num_layers))
        self.register_buffer("w_avg", torch.zeros(w_dim)
                             if w_avg_beta is not None else None)

    def forward(self, z: torch.Tensor, truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                skip_w_avg_update: bool = False) -> torch.Tensor:
        x = normalize_2nd_moment(z)
        for layer in self.layers:
            x = layer(x)
        if self.w_avg is not None and self.training and not skip_w_avg_update:
            with torch.no_grad():
                mean = x.detach().mean(dim=0).to(self.w_avg.dtype)
                self.w_avg.copy_(mean + self.w_avg_beta * (self.w_avg - mean))
        x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1.0:
            if self.w_avg is None:
                raise ValueError("truncation_psi != 1 needs a tracked w_avg "
                                 "(a mapping network with w_avg_beta)")
            w_avg = self.w_avg.to(x.dtype)
            trunc = w_avg + truncation_psi * (x - w_avg)
            if truncation_cutoff is None:
                x = trunc
            else:
                x = torch.cat([trunc[:, :truncation_cutoff],
                               x[:, truncation_cutoff:]], dim=1)
        return x


def _add_noise(x, strength, noise_const, noise_mode, generator, noise,
               resolution):
    """x plus the layer's noise times ``strength``: a draw from
    ``generator`` (or the given ``noise``) in "random" mode, the stored
    ``noise_const`` in "const" mode, nothing in "none" mode."""
    if noise_mode not in _NOISE_MODES:
        raise ValueError(f"noise_mode must be one of {_NOISE_MODES}")
    ns = strength.to(x.dtype)
    if noise_mode == "random":
        if noise is None:
            if generator is None:
                raise ValueError("noise_mode='random' needs a "
                                 "torch.Generator or given noise")
            noise = torch.randn((x.shape[0], 1, resolution, resolution),
                                generator=generator, device=x.device,
                                dtype=x.dtype)
        return x + noise.to(x.dtype) * ns
    if noise_mode == "const":
        return x + noise_const.to(x.dtype) * ns
    return x


class SynthesisLayer(nn.Module):
    """Affine styles -> modulated conv (pad k//2) -> optional smooth 2x
    upsample -> noise -> bias + lrelu + sqrt(2) gain, clamped at 256."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: bool = False):
        super().__init__()
        self.resolution = resolution
        self.kernel_size = kernel_size
        self.up = up
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.noise_strength = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("noise_const",
                             torch.zeros(resolution, resolution))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator)
        normal_(self.noise_const, generator)
        self.noise_strength.zero_()
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise`` (N, 1, res, res) replaces the random draw."""
        styles = self.affine(w)
        # int8 serving (utils/quantize.py): the scaled-activation modconv
        # has a static base weight, so a hook quantizes it like a conv
        quant = active_hook()
        if quant is not None:
            x = quant.modconv(self.weight, x, styles,
                              padding=self.kernel_size // 2, demodulate=True)
        else:
            x = modulated_conv2d(x, self.weight, styles,
                                 padding=self.kernel_size // 2,
                                 demodulate=True)
        if self.up:
            x = smooth_upsample(x)
        x = _add_noise(x, self.noise_strength, self.noise_const, noise_mode,
                       generator, noise, self.resolution)
        return bias_act(x, self.bias, act="lrelu", clamp=256.0)


class ToRGBLayer(nn.Module):
    """Styles scaled by 1/sqrt(in * k^2), non-demodulated 1x1 modulated conv,
    bias, clamp at 256."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        quant = active_hook()
        if quant is not None:
            x = quant.modconv(self.weight, x, styles, padding=0,
                              demodulate=False)
        else:
            x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return torch.clamp(x + self.bias.to(x.dtype)[:, None, None], -256,
                           256)


class AdaIN(nn.Module):
    """Instance norm, then the style's first half as gamma and its second
    as beta: ``gamma * norm(x) + beta`` per sample and channel."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.norm = InstanceNorm2d(in_channels)

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        gamma, beta = style.to(x.dtype).chunk(2, dim=1)
        return gamma[:, :, None, None] * self.norm(x) + beta[:, :, None, None]


class SynthesisLayer1(nn.Module):
    """StyleGAN1 synthesis layer: equalized conv (pad k//2) -> optional
    smooth 2x upsample -> noise -> bias + lrelu + sqrt(2) gain, clamped at
    256 -> ``AdaIN`` with ``affine(w)`` (2 * out_channels, bias 1) as
    (gamma, beta). The arguments and noise modes of ``SynthesisLayer``."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, kernel_size: int = 3, up: bool = False):
        super().__init__()
        self.resolution = resolution
        self.kernel_size = kernel_size
        self.up = up
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.affine = FullyConnectedLayer(w_dim, out_channels * 2,
                                          bias_init=1.0)
        self.ada_in = AdaIN(out_channels)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.noise_strength = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("noise_const",
                             torch.zeros(resolution, resolution))

    init_weights_ = SynthesisLayer.init_weights_

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                noise_mode: str = "random",
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        styles = self.affine(w)
        x = F.conv2d(x, self.weight.to(x.dtype) * self.weight_gain,
                     padding=self.kernel_size // 2)
        if self.up:
            x = smooth_upsample(x)
        x = _add_noise(x, self.noise_strength, self.noise_const, noise_mode,
                       generator, noise, self.resolution)
        x = bias_act(x, self.bias, act="lrelu", clamp=256.0)
        return self.ada_in(x, styles)


class ToRGBLayer1(nn.Module):
    """StyleGAN1 to-RGB: a style-free equalized 1x1 conv (no padding) plus
    bias, clamped at 256; w is taken and ignored."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int = 512,
                 kernel_size: int = 1):
        super().__init__()
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    init_weights_ = ToRGBLayer.init_weights_

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight.to(x.dtype) * self.weight_gain)
        return torch.clamp(x + self.bias.to(x.dtype)[:, None, None], -256,
                           256)


def _layer_family(synthesis_layer: str):
    """(synthesis layer, to-RGB layer) classes of ``synthesis_layer``."""
    if synthesis_layer not in _SYNTHESIS_LAYERS:
        raise ValueError(f"synthesis_layer {synthesis_layer!r}: "
                         f"{'|'.join(_SYNTHESIS_LAYERS)}")
    if synthesis_layer == "stylegan2":
        return SynthesisLayer, ToRGBLayer
    return SynthesisLayer1, ToRGBLayer1


class SynthesisPrologue(nn.Module):
    """Learned const input -> conv1 -> torgb."""

    def __init__(self, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, synthesis_layer: str = "stylegan2"):
        super().__init__()
        layer, torgb = _layer_family(synthesis_layer)
        self.const = nn.Parameter(torch.zeros(out_channels, resolution,
                                              resolution))
        self.conv1 = layer(out_channels, out_channels, w_dim, resolution)
        self.torgb = torgb(out_channels, img_channels, w_dim)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        normal_(self.const, generator)

    def forward(self, ws, noise_mode="random", generator=None, noises=None):
        # a copy, not a view of the parameter: a view made under no_grad
        # has requires_grad and no grad_fn, which FlopCounterMode's module
        # tracker refuses
        x = self.const.to(ws.dtype)[None].repeat(ws.shape[0], 1, 1, 1)
        x = self.conv1(x, ws[:, 0], noise_mode, generator,
                       None if noises is None else noises[0])
        return x, self.torgb(x, ws[:, 1])


class SynthesisBlock(nn.Module):
    """conv0 (up) -> conv1 -> torgb; the image skip is upsampled and
    summed."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 resolution: int, img_channels: int,
                 synthesis_layer: str = "stylegan2"):
        super().__init__()
        layer, torgb = _layer_family(synthesis_layer)
        self.conv0 = layer(in_channels, out_channels, w_dim, resolution,
                           up=True)
        self.conv1 = layer(out_channels, out_channels, w_dim, resolution)
        self.torgb = torgb(out_channels, img_channels, w_dim)

    def forward(self, x, img, ws, noise_mode="random", generator=None,
                noises=None):
        n0, n1 = (None, None) if noises is None else noises
        x = self.conv0(x, ws[:, 0], noise_mode, generator, n0)
        x = self.conv1(x, ws[:, 1], noise_mode, generator, n1)
        y = self.torgb(x, ws[:, 2])
        return x, smooth_upsample(img) + y


def channels_for(resolutions, channel_base=16384, channel_max=512):
    return {res: min(channel_base // res, channel_max) for res in resolutions}


class SynthesisNetwork(nn.Module):
    """Block pyramid 4 -> img_resolution; ws split as [0:2], then
    [2n+1 : 2n+4] for block n."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 16384, channel_max: int = 512,
                 synthesis_layer: str = "stylegan2"):
        super().__init__()
        res = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
        self.num_ws = 2 * (len(res) + 1)
        chans = channels_for(res, channel_base, channel_max)
        self.first_block = SynthesisPrologue(chans[res[0]], w_dim, res[0],
                                             img_channels, synthesis_layer)
        self.blocks = nn.ModuleList(
            SynthesisBlock(chans[r // 2], chans[r], w_dim, r, img_channels,
                           synthesis_layer)
            for r in res[1:])

    def noise_shapes(self, batch: int):
        """The (N, 1, res, res) shape of each layer's noise, forward order."""
        res = [self.first_block.conv1.resolution]
        for block in self.blocks:
            res += [block.conv0.resolution, block.conv1.resolution]
        return [(batch, 1, r, r) for r in res]

    def forward(self, ws, noise_mode="random", generator=None, noises=None):
        """``noises``: one tensor per layer as ``noise_shapes`` lists them,
        in place of the random draws."""
        if noises is not None and len(noises) != 1 + 2 * len(self.blocks):
            raise ValueError(f"{len(noises)} noises for "
                             f"{1 + 2 * len(self.blocks)} layers")
        x, img = self.first_block(ws[:, 0:2], noise_mode, generator,
                                  None if noises is None else noises[:1])
        for n, block in enumerate(self.blocks):
            x, img = block(x, img, ws[:, 2 * n + 1: 2 * n + 4], noise_mode,
                           generator,
                           None if noises is None
                           else noises[1 + 2 * n: 3 + 2 * n])
        return img


class Generator(nn.Module):
    """Mapping + synthesis. ``forward`` takes z, or w when
    ``input_is_latent``, and returns the NCHW image. ``synthesis_layer``
    picks the StyleGAN2 ("stylegan2") or StyleGAN1 ("stylegan1") layer
    family."""

    def __init__(self, z_dim: int = 512, w_dim: int = 512,
                 w_num_layers: int = 8, img_resolution: int = 256,
                 img_channels: int = 3, synthesis_layer: str = "stylegan2"):
        super().__init__()
        self.z_dim = z_dim
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          synthesis_layer=synthesis_layer)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, w_dim, num_ws=self.num_ws,
                                      num_layers=w_num_layers)

    def forward(self, z: torch.Tensor, noise_mode: str = "random",
                input_is_latent: bool = False,
                generator: Optional[torch.Generator] = None,
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                skip_w_avg_update: bool = False,
                noises=None) -> torch.Tensor:
        ws = z if input_is_latent else self.mapping(
            z, truncation_psi, truncation_cutoff, skip_w_avg_update)
        return self.synthesis(ws, noise_mode, generator, noises)

    @torch.no_grad()
    def mean_latent(self, n_latent: int, generator: torch.Generator,
                    batch: int = 8192) -> torch.Tensor:
        """Average mapped w over ``n_latent`` z drawn from ``generator``
        (on the generator's device), as (num_ws, w_dim)."""
        total = None
        done = 0
        dev = self.mapping.w_avg.device
        while done < n_latent:
            b = min(batch, n_latent - done)
            z = torch.randn((b, self.z_dim), generator=generator, device=dev)
            s = self.mapping(z, skip_w_avg_update=True)[:, 0].float().sum(0)
            total = s if total is None else total + s
            done += b
        return (total / n_latent)[None].repeat(self.num_ws, 1)
