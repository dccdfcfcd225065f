"""ReStyle e4e (NCHW): the progressive encoder, the latent-code
discriminator, the replay pool of codes and the e4e inversion model, as
``stylegan_for_facerec_tpu/models/e4e.py``."""

from __future__ import annotations

import random
from typing import List

import torch
from torch import nn

from ..nn.initializers import kaiming_uniform_, uniform_fanin_bias_
from .psp import BackboneEncoder, PSp

PROGRESSIVE_STAGE_INFERENCE = 18


class ProgressiveBackboneEncoder(BackboneEncoder):
    """``BackboneEncoder``'s modules and parameter names; the forward
    broadcasts ``w0 = styles[0](x)`` to every row and adds
    ``styles[i](x)`` to rows 1..min(stage, n_styles - 1). ``stage`` is a
    plain attribute: ``set_stage`` changes it in place."""

    def __init__(self, num_layers: int = 50, mode: str = "ir_se",
                 n_styles: int = 18, input_nc: int = 6,
                 style_spatial: int = 9,
                 stage: int = PROGRESSIVE_STAGE_INFERENCE):
        super().__init__(num_layers, mode, n_styles, input_nc=input_nc,
                         style_spatial=style_spatial)
        self.stage = stage

    def set_stage(self, stage: int) -> None:
        self.stage = stage

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.features(x)
        n = len(self.styles)
        active = min(self.stage, n - 1)
        w0 = self.styles[0](x)
        ws = [w0] + [w0 + self.styles[i](x) for i in range(1, active + 1)]
        return torch.stack(ws + [w0] * (n - 1 - active), dim=1)


class LatentCodesDiscriminator(nn.Module):
    """(n_mlp - 1) x [Linear(style_dim, style_dim) + LeakyReLU(0.2)] then
    Linear(512, 1), under ``mlp``; torch's default init."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 4):
        super().__init__()
        layers = []
        for _ in range(n_mlp - 1):
            layers += [nn.Linear(style_dim, style_dim), nn.LeakyReLU(0.2)]
        layers.append(nn.Linear(512, 1))
        self.mlp = nn.Sequential(*layers)

    def init_weights_(self, generator: torch.Generator):
        for m in self.mlp:
            if isinstance(m, nn.Linear):
                kaiming_uniform_(m.weight, generator)
                uniform_fanin_bias_(m.bias, m.in_features, generator)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return self.mlp(w)


class LatentCodesPool:
    """Replay buffer of codes, with the JAX package's ``random.Random``
    call sequence, so the same queries return the same rows. The rows stay
    on the device they came from."""

    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = pool_size
        self.rng = random.Random(seed)
        self.num_ws = 0
        self.ws: List[torch.Tensor] = []

    def query(self, ws: torch.Tensor) -> torch.Tensor:
        """ws: (B, 512), or (B, n, 512), of which each item gives one random
        row. Returns (B, 512), or ``ws`` itself when the pool size is 0."""
        if self.pool_size == 0:
            return ws
        out = []
        for w in ws:
            if w.ndim == 2:
                w = w[self.rng.randint(0, len(w) - 1)]
            self._handle(w, out)
        return torch.stack(out, 0)

    def _handle(self, w: torch.Tensor, out: List[torch.Tensor]) -> None:
        if self.num_ws < self.pool_size:
            self.num_ws += 1
            self.ws.append(w)
            out.append(w)
        elif self.rng.uniform(0, 1) > 0.5:
            rid = self.rng.randint(0, self.pool_size - 1)
            out.append(self.ws[rid])
            self.ws[rid] = w
        else:
            out.append(w)


class E4e(PSp):
    """``PSp`` with the progressive encoder: the residual latent step and
    ``face_pool`` are PSp's. ``set_stage`` sets the encoder's stage."""

    encoder_class = ProgressiveBackboneEncoder

    @property
    def stage(self) -> int:
        return self.encoder.stage

    def set_stage(self, stage: int) -> "E4e":
        self.encoder.set_stage(stage)
        return self
