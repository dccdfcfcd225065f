"""The port's inversion checkpoint: one ``torch.save`` file holding the
state_dict, the out-of-band ``latent_avg`` and, when known, ``avg_image``
((H, W, 3) in [-1, 1])."""

from __future__ import annotations

from typing import Optional

import torch

from ..models.psp import PSp


def save_checkpoint(path: str, model: PSp,
                    avg_image: Optional[torch.Tensor] = None) -> None:
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()},
                "latent_avg": model.latent_avg.cpu(),
                "avg_image": None if avg_image is None else avg_image.cpu()},
               path)


def load_checkpoint(path: str, model: PSp) -> Optional[torch.Tensor]:
    """Load weights and ``latent_avg`` into ``model`` strictly; returns the
    stored ``avg_image`` (on the CPU) or None."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    with torch.no_grad():
        model.latent_avg.copy_(ckpt["latent_avg"])
    return ckpt.get("avg_image")
