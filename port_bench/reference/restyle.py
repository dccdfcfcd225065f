"""Plain reference of ReStyle iterative inversion: the pSp
``BackboneEncoder`` (IR-SE-50 over the image and the current
reconstruction, map2style heads), the StyleGAN2-ADA generator (mapping
network, modulated convolutions in their scaled-activation form, the
smooth 2x upsample, bias + lrelu + clamp, const noise), ``face_pool`` to
256 and the latent carried from one iteration to the next.

Written from the architecture as the port implements it, at commit
dd4ae0b: ``stylegan_for_facerec_torch/models/psp.py`` (``PSp``,
``BackboneEncoder``, ``GradualStyleBlock``), ``models/stylegan2_ada.py``,
``models/stylegan2.py`` (``EqualLinear``), ``ops/modconv.py``,
``eval/inference.py`` (``run_on_batch``) and ``train/stage2.py``
(``make_avg_image``). Parameter and buffer names are the port's; nothing
here imports the port. Computed in float32 (``Precision("fp8")`` rounds
the operands of every convolution and matrix product).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .facerec import (IR_SE_LAYOUTS, Run, ir_body, ir_input_layer,
                      run_input_and_body, weight_table)
from .ops import Precision, bias_act, smooth_upsample


class StyleBlock(nn.Module):
    """map2style: log2(spatial) stride-2 3x3 convs with LeakyReLU(0.01) down
    to 1x1, then an equalized Linear (weight N(0, 1), gain 1 / sqrt(in))."""

    def __init__(self, c: int, spatial: int):
        super().__init__()
        n = int(math.log2(spatial))
        layers = []
        for _ in range(n):
            layers += [nn.Conv2d(c, c, 3), nn.LeakyReLU()]
        self.convs = nn.Sequential(*layers)
        self.linear = nn.Linear(c, c)

    def forward(self, x, run: Run):
        for conv in self.convs[0::2]:
            x = F.leaky_relu(run.conv(conv, x, 2, 1), 0.01)
        lin = self.linear
        return run.prec.linear(x.reshape(x.shape[0], -1),
                               lin.weight / math.sqrt(lin.in_features),
                               lin.bias)


class Encoder(nn.Module):
    def __init__(self, num_layers: int, n_styles: int, input_nc: int,
                 style_spatial: int):
        super().__init__()
        self.input_layer = ir_input_layer(input_nc)
        self.body = ir_body(IR_SE_LAYOUTS[num_layers])
        self.styles = nn.ModuleList(StyleBlock(512, style_spatial)
                                    for _ in range(n_styles))

    def forward(self, x, run: Run):
        x = run_input_and_body(self.input_layer, self.body, x, run)
        return torch.stack([s(x, run) for s in self.styles], dim=1)


class FC(nn.Module):
    """Equalized dense layer: y = x (W lr / sqrt(in))^T + b lr, optional
    lrelu with sqrt 2 gain."""

    def __init__(self, cin: int, cout: int, lr_mul: float = 1.0,
                 lrelu: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.lr_mul, self.lrelu = lr_mul, lrelu

    def forward(self, x, prec: Precision):
        w = self.weight * (self.lr_mul / math.sqrt(self.weight.shape[1]))
        y = prec.linear(x, w, self.bias * self.lr_mul)
        return F.leaky_relu(y, 0.2) * math.sqrt(2.0) if self.lrelu else y


class Mapping(nn.Module):
    def __init__(self, z_dim: int, w_dim: int, num_layers: int):
        super().__init__()
        dims = [z_dim] + [w_dim] * num_layers
        self.layers = nn.ModuleList(FC(dims[i], dims[i + 1], 0.01, True)
                                    for i in range(num_layers))
        self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z, prec: Precision):
        x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
        for layer in self.layers:
            x = layer(x, prec)
        return x


def modconv(x, weight, styles, padding: int, demodulate: bool,
            prec: Precision):
    """StyleGAN2-ADA's modulated convolution, non-fused form: the input
    scaled by the styles, one convolution, the output scaled by each
    sample's demodulation coefficients rsqrt(sum (w s)^2 + 1e-8)."""
    y = prec.conv2d(x * styles[:, :, None, None], weight, padding=padding)
    if demodulate:
        d = torch.rsqrt(styles.square() @ weight.square().sum(
            dim=(2, 3)).t() + 1e-8)
        y = y * d[:, :, None, None]
    return y


class Layer(nn.Module):
    """Affine -> modulated 3x3 conv -> [smooth upsample] -> const noise x
    strength -> bias + lrelu (gain sqrt 2), clamped at 256."""

    tally: Optional[List] = None

    def __init__(self, cin: int, cout: int, w_dim: int, res: int,
                 up: bool = False):
        super().__init__()
        self.up = up
        self.affine = FC(w_dim, cin)
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.noise_strength = nn.Parameter(torch.zeros(1))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("noise_const", torch.zeros(res, res))

    def forward(self, x, w, prec: Precision):
        x = modconv(x, self.weight, self.affine(w, prec), 1, True, prec)
        if self.up:
            x = smooth_upsample(x, self.tally)
        x = x + self.noise_const * self.noise_strength
        return bias_act(x, self.bias, "lrelu", clamp=256.0, tally=self.tally)


class ToRGB(nn.Module):
    def __init__(self, cin: int, w_dim: int, img_channels: int = 3):
        super().__init__()
        self.affine = FC(w_dim, cin)
        self.weight = nn.Parameter(torch.zeros(img_channels, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(img_channels))

    def forward(self, x, w, prec: Precision):
        styles = self.affine(w, prec) / math.sqrt(self.weight.shape[1])
        x = modconv(x, self.weight, styles, 0, False, prec)
        return torch.clamp(x + self.bias[:, None, None], -256, 256)


class First(nn.Module):
    def __init__(self, c: int, w_dim: int):
        super().__init__()
        self.const = nn.Parameter(torch.zeros(c, 4, 4))
        self.conv1 = Layer(c, c, w_dim, 4)
        self.torgb = ToRGB(c, w_dim)


class Block(nn.Module):
    tally: Optional[List] = None

    def __init__(self, cin: int, cout: int, w_dim: int, res: int):
        super().__init__()
        self.conv0 = Layer(cin, cout, w_dim, res, up=True)
        self.conv1 = Layer(cout, cout, w_dim, res)
        self.torgb = ToRGB(cout, w_dim)


class Synthesis(nn.Module):
    """4x4 const -> one layer per 4x4, two per later resolution (the first
    upsampling), a to-RGB at each, the image skip upsampled and summed;
    channels min(channel_base / res, 512)."""

    def __init__(self, w_dim: int, resolution: int, channel_base: int,
                 channel_max: int = 512):
        super().__init__()
        res = [2 ** i for i in range(2, int(math.log2(resolution)) + 1)]
        ch = {r: min(channel_base // r, channel_max) for r in res}
        self.first_block = First(ch[4], w_dim)
        self.blocks = nn.ModuleList(Block(ch[r // 2], ch[r], w_dim, r)
                                    for r in res[1:])

    def forward(self, ws, prec: Precision):
        f = self.first_block
        x = f.const[None].expand(ws.shape[0], -1, -1, -1)
        x = f.conv1(x, ws[:, 0], prec)
        img = f.torgb(x, ws[:, 1], prec)
        for n, b in enumerate(self.blocks):
            x = b.conv0(x, ws[:, 2 * n + 1], prec)
            x = b.conv1(x, ws[:, 2 * n + 2], prec)
            img = smooth_upsample(img, b.tally) + b.torgb(x, ws[:, 2 * n + 3],
                                                          prec)
        return img


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.synthesis = Synthesis(cfg["w_dim"], cfg["output_size"],
                                   cfg["channel_base"])
        self.mapping = Mapping(cfg["z_dim"], cfg["w_dim"],
                               cfg["mapping_layers"])


class ReStyle(nn.Module):
    """The inversion model; ``latent_avg`` and ``avg_image`` are worked out
    here from the mapping network (``mean_latent``, ``make_avg_image``)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.n_styles = 2 * int(math.log2(cfg["output_size"]))
        self.encoder = Encoder(cfg["encoder_num_layers"], self.n_styles,
                               cfg["input_nc"], 9)
        self.decoder = Decoder(cfg)

    def kernel_calls(self, tally: Optional[List]):
        """Record each bias_act and smooth_upsample call into ``tally``
        (None: stop recording)."""
        for m in self.modules():
            if isinstance(m, (Layer, Block)):
                m.tally = tally

    @torch.no_grad()
    def mean_latent(self, z: torch.Tensor, prec: Precision) -> torch.Tensor:
        """(n_styles, w_dim): the mean mapped w of ``z``."""
        w = self.decoder.mapping(z, prec).mean(0)
        return w[None].repeat(self.n_styles, 1)

    @torch.no_grad()
    def make_avg_image(self, latent_avg, prec: Precision, size: int):
        """``latent_avg`` synthesised with const noise, pooled to 256,
        cropped [35:223, 30:218], resized bilinearly to ``size``: (size,
        size, 3) clamped to [-1, 1]."""
        img = self.decoder.synthesis(latent_avg[None], prec)
        img = F.adaptive_avg_pool2d(img, 256)[:, :, 35:223, 30:218]
        img = F.interpolate(img, size=(size, size), mode="bilinear",
                            align_corners=False)
        return img[0].permute(1, 2, 0).clamp(-1, 1)

    @torch.no_grad()
    def iterate(self, x, cond, latent, prec: Precision):
        """One iteration: x and cond NCHW at the input size, latent (B or 1,
        n_styles, w_dim); returns (the output NCHW at 256, the new
        latent)."""
        latent = self.encoder(torch.cat([x, cond.expand_as(x)], 1),
                              Run(prec, None, False)) + latent
        y = F.adaptive_avg_pool2d(self.decoder.synthesis(latent, prec), 256)
        return y, latent

    @staticmethod
    def condition(y, size: int):
        """The next iteration's conditioning: the output resized bilinearly
        to the input size."""
        return F.interpolate(y, size=(size, size), mode="bilinear",
                             align_corners=False)

    @torch.no_grad()
    def invert(self, inputs, avg_image, latent_avg, n_iters: int,
               prec: Precision):
        """inputs (B, H, W, 3), avg_image (H, W, 3): (outputs per iteration
        (iters, B, 256, 256, 3), latents (iters, B, n_styles, w_dim))."""
        x = inputs.permute(0, 3, 1, 2)
        cond = avg_image.permute(2, 0, 1)[None]
        latent = latent_avg[None]
        outs, lats = [], []
        for _ in range(n_iters):
            y, latent = self.iterate(x, cond, latent, prec)
            outs.append(y.permute(0, 2, 3, 1))
            lats.append(latent)
            cond = self.condition(y, x.shape[-1])
        return torch.stack(outs), torch.stack(lats)


def restyle_weight_table(cfg: dict):
    """The draw of the inversion model's weights (port names): the encoder
    as the stage-3 backbone's but with BatchNorm's shifts N(0, 1e-4) and
    the map2style Linear's weights N(0, 64), so that the codes depend on
    the input and move from the average by tens of percent an iteration,
    as a trained encoder's do (with the stage-3 draw they move by 5 %,
    alike for every input); map2style convs N(0, 1 / fan_in); the
    generator's equalized weights N(0, 1) (the mapping's N(0, 1e4), its
    lr multiplier 0.01), affine biases near 1, small biases and noise
    strengths, unit const input and noise."""
    with torch.device("meta"):
        model = ReStyle(cfg)
    rows = []
    for name, shape, dtype, rule in weight_table(model):
        if name.startswith("decoder."):
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("decoder.mapping.layers"):
                rule = (0.0, 100.0) if leaf == "weight" else (0.0, 0.1)
            elif ".affine." in name:
                rule = (0.0, 1.0) if leaf == "weight" else (1.0, 0.1)
            elif leaf in ("bias", "noise_strength"):
                rule = (0.0, 0.1)
            else:
                rule = (0.0, 1.0)
        elif ".styles." in name:
            fan_in = math.prod(shape[1:])
            rule = (0.0, 8.0) if name.endswith("linear.weight") else \
                (0.0, 0.01) if name.endswith("bias") else \
                (0.0, 1.0 / math.sqrt(fan_in))
        elif name.endswith((".running_mean", ".bias")):
            rule = (0.0, 0.01)
        rows.append((name, shape, dtype, rule))
    return rows
