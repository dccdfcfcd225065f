"""Identity-similarity losses for stage-2 inversion training, as
``stylegan_for_facerec_tpu/losses/identity.py``: ``w_norm_loss``, the
shared body ``similarity_loss`` of the ID and MoCo losses, and the MoCo
feature path. Images are NHWC in [-1, 1], as in the JAX package. The
IR-SE-50 ID extractor waits for the face-recognition ``Backbone``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..ops.image import resize_bilinear


def w_norm_loss(latent: torch.Tensor,
                latent_avg: Optional[torch.Tensor] = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """Sum over the batch of ||latent (- avg)||_F, / B."""
    if start_from_latent_avg:
        latent = latent - latent_avg
    norms = torch.sqrt(torch.sum(torch.square(latent), dim=(1, 2)))
    return torch.sum(norms) / latent.shape[0]


def make_moco_extractor(feature_fn: Callable) -> Callable:
    """The MoCo loss's feature path: resize to 224, embed, L2-normalise.
    ``feature_fn`` maps (B, 224, 224, 3) -> (B, D)."""

    def extract(x: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(x.permute(0, 3, 1, 2), 224, 224)
        f = feature_fn(x.permute(0, 2, 3, 1))
        return f / torch.linalg.norm(f, dim=1, keepdim=True)

    return extract


def similarity_loss(extract: Callable, y_hat: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor):
    """Returns (loss, sim_improvement, logs); y's features are detached."""
    x_feats = extract(x)
    y_feats = extract(y).detach()
    y_hat_feats = extract(y_hat)
    diff_target = torch.sum(y_hat_feats * y_feats, dim=1)
    diff_input = torch.sum(y_hat_feats * x_feats, dim=1)
    diff_views = torch.sum(y_feats * x_feats, dim=1)
    loss = torch.mean(1.0 - diff_target)
    sim_improvement = torch.mean(diff_target - diff_views)
    logs = {"diff_target": diff_target, "diff_input": diff_input,
            "diff_views": diff_views}
    return loss, sim_improvement, logs
