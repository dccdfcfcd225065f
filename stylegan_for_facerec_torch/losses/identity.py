"""Identity-similarity losses for stage-2 inversion training, as
``stylegan_for_facerec_tpu/losses/identity.py``: ``w_norm_loss``, the
shared body ``similarity_loss`` of the ID and MoCo losses, the MoCo
feature path, and the IR-SE-50 ID extractor with ``id_loss``. Images are
NHWC in [-1, 1], as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..models.irse import Backbone
from ..ops.image import resize_bilinear


def w_norm_loss(latent: torch.Tensor,
                latent_avg: Optional[torch.Tensor] = None,
                start_from_latent_avg: bool = True) -> torch.Tensor:
    """Sum over the batch of ||latent (- avg)||_F, / B."""
    if start_from_latent_avg:
        latent = latent - latent_avg
    norms = torch.sqrt(torch.sum(torch.square(latent), dim=(1, 2)))
    return torch.sum(norms) / latent.shape[0]


def make_irse_id_extractor(backbone: Backbone) -> Callable:
    """The ID loss's feature path: crop the face region ([35:223, 32:220]
    of a 256 px image, scaled to the input's size), adaptive-average-pool
    to 112, embed with ``backbone`` (an IR-SE-50 ``Backbone``, switched to
    eval mode here, as the frozen face network is), L2-normalise."""
    backbone.eval()

    def extract(x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        t, b = round(35 * h / 256), round(223 * h / 256)
        l, r = round(32 * w / 256), round(220 * w / 256)
        x = F.adaptive_avg_pool2d(x[:, t:b, l:r, :].permute(0, 3, 1, 2), 112)
        feats = backbone(x)
        return feats / torch.linalg.norm(feats, dim=1, keepdim=True)

    return extract


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


def id_loss(backbone: Backbone, y_hat: torch.Tensor, y: torch.Tensor,
            x: torch.Tensor):
    return similarity_loss(make_irse_id_extractor(backbone), y_hat, y, x)
