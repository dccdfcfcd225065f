"""ReStyle pSp models (NCHW): the inversion model (IR-SE encoder with
map2style heads, the residual latent step, the StyleGAN2-ADA generator),
the stage-3 face-recognition backbone built from the same encoder trunk,
and the rest of the pSp encoder family (the FPN ``GradualStyleEncoder``,
``ResNetBackboneEncoder``, ``PSPOutputLayer``) behind ``build_encoder``."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.initializers import (init_conv_torch_default_, init_conv_xavier_,
                               init_weights, xavier_uniform_)
from ..nn.layers import BatchNorm2d
from ..ops.image import resize_bilinear, resize_bilinear_align_corners
from ..utils.device import resolve_device
from .irse import (BottleneckIR, end_spatial, facerec_output_layer,
                   get_blocks, init_stem_and_head_)
from .resnet import BasicBlock
from .stylegan2 import EqualLinear
from .stylegan2_ada import Generator


class GradualStyleBlock(nn.Module):
    """map2style head: log2(spatial) stride-2 convs with LeakyReLU(0.01)
    down to 1x1, then an EqualLinear."""

    def __init__(self, in_c: int, out_c: int, spatial: int):
        super().__init__()
        self.out_c = out_c
        self.spatial = spatial
        num_pools = int(np.log2(spatial))
        convs = [nn.Conv2d(in_c, out_c, 3, stride=2, padding=1),
                 nn.LeakyReLU()]
        for _ in range(num_pools - 1):
            convs += [nn.Conv2d(out_c, out_c, 3, stride=2, padding=1),
                      nn.LeakyReLU()]
        self.convs = nn.Sequential(*convs)
        self.linear = EqualLinear(out_c, out_c, lr_mul=1)

    def init_weights_(self, generator: torch.Generator):
        for m in self.convs:
            if isinstance(m, nn.Conv2d):
                init_conv_torch_default_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.convs(x)
        if x.shape[2] != 1 or x.shape[3] != 1:
            raise ValueError(
                f"GradualStyleBlock(spatial={self.spatial}) ended at "
                f"{x.shape[2]}x{x.shape[3]}, not 1x1: the encoder's "
                f"style_spatial does not match the input resolution (use "
                f"style_spatial_for(input_size)); reshaping would corrupt "
                f"the batch dimension")
        return self.linear(x.reshape(-1, self.out_c))


class PSPOutputLayer(nn.Module):
    """``n_styles`` map2style heads on one feature map, stacked to
    (N, n_styles, out_c)."""

    def __init__(self, in_c: int, out_c: int, spatial: int,
                 n_styles: int = 18):
        super().__init__()
        self.styles = nn.ModuleList(GradualStyleBlock(in_c, out_c, spatial)
                                    for _ in range(n_styles))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.stack([s(x) for s in self.styles], dim=1)


def _ir_input_layer(in_channels: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_channels, 64, 3, padding=1, bias=False),
                         BatchNorm2d(64), nn.PReLU(64))


def _ir_body(num_layers: int, mode: str,
             block_dropout: Optional[float] = None) -> nn.Sequential:
    return nn.Sequential(*[
        BottleneckIR(i, d, s, se=mode == "ir_se", dropout=block_dropout)
        for i, d, s in get_blocks(num_layers)])


class BackboneEncoder(nn.Module):
    """ReStyle encoder: IR-SE body over ``input_nc``-channel input and
    ``n_styles`` map2style heads on its last feature map."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 n_styles: int = 18, input_nc: int = 6,
                 style_spatial: int = 9):
        super().__init__()
        self.input_layer = _ir_input_layer(input_nc)
        self.body = _ir_body(num_layers, mode)
        self.styles = nn.ModuleList(GradualStyleBlock(512, 512, style_spatial)
                                    for _ in range(n_styles))

    def init_weights_(self, generator: torch.Generator):
        init_conv_xavier_(self.input_layer[0], generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """input_layer + body: the map the style heads read."""
        return self.body(self.input_layer(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        return torch.stack([s(x) for s in self.styles], dim=1)


class GradualStyleEncoder(nn.Module):
    """The pixel2style2pixel FPN encoder: IR-SE body tapped after units 6,
    20 and 23 (the ends of the 128-, 256- and 512-channel stages), lateral
    1x1 convs, and coarse / middle / fine style heads (spatial 16 / 32 /
    64) on the pyramid levels, each level the previous one upsampled
    bilinearly with aligned corners plus the lateral map."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 n_styles: int = 18, input_nc: int = 6,
                 coarse_ind: int = 3, middle_ind: int = 7):
        super().__init__()
        self.coarse_ind, self.middle_ind = coarse_ind, middle_ind
        self.input_layer = _ir_input_layer(input_nc)
        self.body = _ir_body(num_layers, mode)
        self.styles = nn.ModuleList(
            GradualStyleBlock(512, 512, 16 if i < coarse_ind
                              else 32 if i < middle_ind else 64)
            for i in range(n_styles))
        self.latlayer1 = nn.Conv2d(256, 512, 1)
        self.latlayer2 = nn.Conv2d(128, 512, 1)

    def init_weights_(self, generator: torch.Generator):
        init_conv_xavier_(self.input_layer[0], generator)
        init_conv_torch_default_(self.latlayer1, generator)
        init_conv_torch_default_(self.latlayer2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.input_layer(x)
        taps = {}
        for i, unit in enumerate(self.body):
            x = unit(x)
            if i in (6, 20, 23):
                taps[i] = x
        c1, c2, c3 = taps[6], taps[20], taps[23]
        styles = self.styles
        latents = [styles[j](c3) for j in range(self.coarse_ind)]
        l1 = self.latlayer1(c2)
        p2 = resize_bilinear_align_corners(c3, *l1.shape[-2:]) + l1
        latents += [styles[j](p2)
                    for j in range(self.coarse_ind, self.middle_ind)]
        l2 = self.latlayer2(c1)
        p1 = resize_bilinear_align_corners(p2, *l2.shape[-2:]) + l2
        latents += [styles[j](p1) for j in range(self.middle_ind, len(styles))]
        return torch.stack(latents, dim=1)


OUTPUT_LAYER_TYPES = ("facerec", "pSp", "both")


class BackboneEncoderDiffHead(nn.Module):
    """The stage-3 encoder: ``in_channels``-channel input layer, IR-SE
    body, and the output layer of ``output_layer_type``: "facerec" (the
    face-recognition embedding), "pSp" (``n_styles`` map2style heads of
    spatial 9, a ``PSPOutputLayer``) or "both", which returns
    {"facerec": embedding, "pSp": styles}. Inputs of another size than
    ``input_size`` are resized bilinearly."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 emb_size: int = 512,
                 input_size: int = 112, output_layer_type: str = "facerec",
                 block_dropout: Optional[float] = None,
                 in_channels: int = 6, n_styles: int = 18):
        super().__init__()
        if output_layer_type not in OUTPUT_LAYER_TYPES:
            raise ValueError(f"output_layer_type {output_layer_type!r}: "
                             f"one of {OUTPUT_LAYER_TYPES}")
        self.input_size = input_size
        self.output_layer_type = output_layer_type
        self.input_layer = _ir_input_layer(in_channels)
        self.body = _ir_body(num_layers, mode, block_dropout)
        if output_layer_type == "facerec":
            self.output_layer = facerec_output_layer(
                end_spatial(input_size), emb_size, 0.5)
        elif output_layer_type == "pSp":
            self.output_layer = PSPOutputLayer(512, 512, 9, n_styles)
        else:
            self.output_layer_facerec = facerec_output_layer(
                end_spatial(input_size), emb_size, 0.5)
            self.output_layer_psp = PSPOutputLayer(512, 512, 9, n_styles)

    def init_weights_(self, generator: torch.Generator):
        if self.output_layer_type == "pSp":
            init_conv_xavier_(self.input_layer[0], generator)
        elif self.output_layer_type == "both":
            init_stem_and_head_(self.input_layer, self.output_layer_facerec,
                                generator)
        else:
            init_stem_and_head_(self.input_layer, self.output_layer,
                                generator)

    def forward(self, x: torch.Tensor):
        if x.shape[2] != self.input_size:
            x = resize_bilinear(x, self.input_size, self.input_size)
        x = self.body(self.input_layer(x))
        if self.output_layer_type != "both":
            return self.output_layer(x)
        return {"facerec": self.output_layer_facerec(x),
                "pSp": self.output_layer_psp(x)}


def _resnet34_trunk() -> nn.Sequential:
    """torchvision resnet34's layer1-4 as one Sequential of BasicBlocks
    (3/4/6/3 blocks of 64/128/256/512 channels)."""
    blocks, inplanes = [], 64
    for planes, n, stride in ((64, 3, 1), (128, 4, 2), (256, 6, 2),
                              (512, 3, 2)):
        for b in range(n):
            s = stride if b == 0 else 1
            blocks.append(BasicBlock(inplanes, planes, s, has_downsample=(
                s != 1 or inplanes != planes)))
            inplanes = planes
    return nn.Sequential(*blocks)


class ResNetBackboneEncoder(nn.Module):
    """conv 7x7 stride 2 -> BN -> PReLU -> the resnet34 trunk -> either
    ``n_styles`` map2style heads of spatial 16 (``output_layer_type``
    "pSp", 256 px input) or the face-recognition embedding ("facerec",
    112 px input: a 7x7 map)."""

    def __init__(self, n_styles: int = 18, input_nc: int = 6,
                 output_layer_type: str = "pSp", emb_size: int = 512):
        super().__init__()
        if output_layer_type not in ("pSp", "facerec"):
            raise ValueError(f"output_layer_type {output_layer_type!r}: "
                             f"pSp|facerec")
        self.output_layer_type = output_layer_type
        self.conv1 = nn.Conv2d(input_nc, 64, 7, stride=2, padding=3,
                               bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = nn.PReLU(64)
        self.body = _resnet34_trunk()
        if output_layer_type == "facerec":
            self.output_layer = facerec_output_layer(7, emb_size, 0.5)
        else:
            self.styles = nn.ModuleList(GradualStyleBlock(512, 512, 16)
                                        for _ in range(n_styles))

    def init_weights_(self, generator: torch.Generator):
        init_conv_torch_default_(self.conv1, generator)
        if self.output_layer_type == "facerec":
            linear = self.output_layer[3]
            xavier_uniform_(linear.weight, generator)
            with torch.no_grad():
                linear.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.body(self.relu(self.bn1(self.conv1(x))))
        if self.output_layer_type == "facerec":
            return self.output_layer(x)
        return torch.stack([s(x) for s in self.styles], dim=1)


class PSpFaceRec(nn.Module):
    """The stage-3 pSp backbone: the image and a fixed average image
    (``avg_image``, a (3, size, size) buffer in [-1, 1] that travels in the
    state_dict) concatenated channel-wise into a
    ``BackboneEncoderDiffHead``. Takes (N, 3, H, W), resized to ``size``
    when H differs."""

    def __init__(self, size: int = 112, num_layers: int = 50,
                 emb_size: int = 512, block_dropout: Optional[float] = None):
        super().__init__()
        self.size = size
        self.encoder = BackboneEncoderDiffHead(
            num_layers, "ir_se", input_size=size, emb_size=emb_size,
            block_dropout=block_dropout)
        self.register_buffer("avg_image", torch.zeros(3, size, size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] != self.size:
            x = resize_bilinear(x, self.size, self.size)
        avg = self.avg_image.to(x.dtype)[None].expand(x.shape[0], -1, -1, -1)
        return self.encoder(torch.cat([x, avg], dim=1))


def n_styles_for(output_size: int, generator_ada: bool = True) -> int:
    """2 * log2(out) - 2, plus 2 for the ADA generator."""
    n = int(math.log2(output_size)) * 2 - 2
    return n + 2 if generator_ada else n


def style_spatial_for(input_size: int) -> int:
    """map2style ``spatial`` for an encoder fed ``input_size`` images: the
    IR body downsamples by 16 and the heads must end at 1x1 (9 for the
    112 px pipeline's 7x7 maps)."""
    fmap = max(1, input_size // 16)
    return 9 if fmap == 7 else 1 << max(1, math.ceil(math.log2(max(2, fmap))))


class PSp(nn.Module):
    """Encoder -> codes (+ the previous latent, or ``latent_avg`` at the
    first iteration) -> generator -> ``face_pool`` to 256.

    ``latent_avg`` is a buffer outside the state_dict: it travels beside
    the weights, as in the reference checkpoints. ``encoder_class`` is the
    encoder a subclass puts in place of ``BackboneEncoder`` (the e4e
    model's progressive encoder); it takes ``BackboneEncoder``'s
    arguments."""

    encoder_class = BackboneEncoder

    def __init__(self, output_size: int = 128, input_nc: int = 6,
                 encoder_num_layers: int = 50, input_size: int = 112):
        super().__init__()
        self.n_styles = n_styles_for(output_size)
        self.encoder = self.encoder_class(
            encoder_num_layers, "ir_se", self.n_styles, input_nc=input_nc,
            style_spatial=style_spatial_for(input_size))
        self.decoder = Generator(z_dim=512, w_dim=512, w_num_layers=8,
                                 img_resolution=output_size, img_channels=3)
        self.face_pool = nn.AdaptiveAvgPool2d((256, 256))
        self.register_buffer("latent_avg", torch.zeros(self.n_styles, 512),
                             persistent=False)

    def forward(self, x: torch.Tensor, latent: Optional[torch.Tensor] = None,
                resize: bool = True, randomize_noise: bool = True,
                return_latents: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (N, input_nc, H, W). Random noise (``randomize_noise``) draws
        from ``generator``."""
        codes = self.encoder(x)
        if latent is not None:
            codes = codes + latent
        else:
            codes = codes + self.latent_avg[None].to(codes.dtype)
        images = self.decoder(
            codes, noise_mode="random" if randomize_noise else "const",
            input_is_latent=True, generator=generator)
        if resize and images.shape[-1] != 256:
            images = self.face_pool(images)
        if return_latents:
            return images, codes
        return images


# the encoder registry of the reference inference scripts; build_encoder
# builds the names it knows and raises for the others
ENCODER_TYPES = {
    "pSp": ("GradualStyleEncoder", "ResNetGradualStyleEncoder",
            "BackboneEncoder", "ResNetBackboneEncoder"),
    "e4e": ("ProgressiveBackboneEncoder",
            "ResNetProgressiveBackboneEncoder"),
}


def build_encoder(encoder_type: str, n_styles: int, input_nc: int = 6,
                  num_layers: int = 50, seed: int = 0,
                  device: str = "cuda") -> nn.Module:
    """An encoder by its reference name, with weights drawn from ``seed``
    on the CPU (so a seed gives the same encoder on every device), moved
    to ``device``. ``num_layers`` reaches only the FPN encoder, as in the
    JAX package; "BackboneEncoder34"/"100" select the IR-SE depth. Raises
    ValueError for a name it does not build, and RuntimeError when
    ``device`` is CUDA and no GPU is found."""
    dev = resolve_device(device)
    depths = {"BackboneEncoder": 50, "BackboneEncoder34": 34,
              "BackboneEncoder100": 100}
    if encoder_type == "GradualStyleEncoder":
        model = GradualStyleEncoder(num_layers, "ir_se", n_styles,
                                    input_nc=input_nc)
    elif encoder_type in depths:
        model = BackboneEncoder(depths[encoder_type], "ir_se", n_styles,
                                input_nc=input_nc)
    elif encoder_type == "ResNetBackboneEncoder":
        model = ResNetBackboneEncoder(n_styles, input_nc=input_nc)
    elif encoder_type == "ProgressiveBackboneEncoder":
        from .e4e import ProgressiveBackboneEncoder
        model = ProgressiveBackboneEncoder(50, "ir_se", n_styles,
                                           input_nc=input_nc)
    else:
        raise ValueError(f"{encoder_type} is not a valid encoder")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def build_psp(output_size: int = 256, input_size: int = 112, seed: int = 0,
              device: str = "cuda", n_latent: int = 4096) -> PSp:
    """A ``PSp`` in eval mode with seeded random weights and ``latent_avg``
    from its own mapping network over ``n_latent`` seeded z. The weights are
    drawn on the CPU, so a seed gives the same model on every device.
    Raises when ``device`` is CUDA and no GPU is found."""
    dev = resolve_device(device)
    model = PSp(output_size=output_size, input_size=input_size)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    with torch.no_grad():
        model.latent_avg.copy_(model.decoder.mean_latent(n_latent, gen))
    return model.eval().to(dev)
