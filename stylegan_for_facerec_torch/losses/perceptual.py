"""LPIPS perceptual loss (v0.1) with an AlexNet or VGG16 trunk.

    score(x, y) = sum over tap layers l of
        mean_spatial( lin_l( (norm(f_l(x)) - norm(f_l(y)))^2 ) )
    summed over the batch, then / B,

with ``norm`` the unit normalisation over channels and ``lin_l`` a frozen
1x1 convolution, as ``stylegan_for_facerec_tpu/losses/perceptual.py``.
Computation is NCHW; ``LPIPS.forward`` takes NHWC images in [-1, 1], as
the JAX package's ``LPIPS.apply`` does. The trunks are torchvision's
``features`` Sequentials, index for index (``net.0``, ``net.3``, ...), and
the lin layers ``lin.{i}`` are (1, C, 1, 1) convolutions, so torchvision's
pretrained ``features`` state_dict loads into ``LPIPS.net`` as it is, and
``utils.convert.from_jax`` fills both from the JAX trees.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..nn.initializers import init_conv_torch_default_, normal_

# z-score of the [-1, 1] input (the reference's ScalingLayer)
_LPIPS_MEAN = (-0.030, -0.088, -0.188)
_LPIPS_STD = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)
VGG_CHANNELS = (64, 128, 256, 512, 512)


def normalize_activation(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise each position's channel vector (dim 1)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class _TapFeatures(nn.Sequential):
    """A torchvision ``features`` Sequential that returns the unit-normalised
    activations after the ReLUs at ``taps`` (0-based indices)."""

    taps: tuple = ()

    def init_weights_(self, generator: torch.Generator):
        for m in self:
            if isinstance(m, nn.Conv2d):
                init_conv_torch_default_(m, generator)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for i, m in enumerate(self):
            x = m(x)
            if i in self.taps:
                out.append(normalize_activation(x))
                if len(out) == len(self.taps):
                    break
        return out


class AlexNetFeatures(_TapFeatures):
    """torchvision ``alexnet().features``; taps after its five ReLUs."""

    taps = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))


class VGG16Features(_TapFeatures):
    """torchvision ``vgg16().features``; taps after the last ReLU of each
    of its five stages."""

    taps = (3, 8, 15, 22, 29)
    _CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
            "M", 512, 512, 512, "M")

    def __init__(self):
        layers, c = [], 3
        for v in self._CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, v, 3, padding=1), nn.ReLU()]
                c = v
        super().__init__(*layers)


class LPIPS(nn.Module):
    """``forward(x, y)``: NHWC images in [-1, 1] -> scalar LPIPS (f32).
    Callers freeze it (``requires_grad_(False)``); gradients flow to the
    images."""

    def __init__(self, net_type: str = "alex"):
        super().__init__()
        if net_type == "alex":
            self.net, chans = AlexNetFeatures(), ALEX_CHANNELS
        elif net_type == "vgg":
            self.net, chans = VGG16Features(), VGG_CHANNELS
        else:
            raise ValueError(f"net_type {net_type!r}: alex|vgg")
        self.lin = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False)
                                 for c in chans)
        self.register_buffer("mean", torch.tensor(_LPIPS_MEAN).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(_LPIPS_STD).reshape(
            1, 3, 1, 1), persistent=False)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        """Positive random lin weights, as the JAX package's random init,
        so that random-weight scores are positive."""
        for lin in self.lin:
            normal_(lin.weight, generator, std=0.1).abs_()

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self.per_sample(x, y).sum() / x.shape[0]

    def per_sample(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(N,) LPIPS of each pair: ``forward`` of that pair alone."""
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        y = (y.permute(0, 3, 1, 2) - self.mean) / self.std
        total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for lin, a, b in zip(self.lin, self.net(x), self.net(y)):
            total = total + lin(torch.square(a - b)).float().mean(
                dim=(1, 2, 3))
        return total
