"""Classification losses for stage 3, as
``stylegan_for_facerec_tpu/losses/focal.py``.

``focal_loss`` keeps the reference ``FocalLoss``'s quirk: the focal
transform is applied to the MEAN cross-entropy, not per sample:

    logp = mean_CE(logits, labels); p = exp(-logp); loss = (1-p)^g * logp

``focal_loss_per_sample`` is the textbook variant. All log-softmax math
runs in float32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch


def cross_entropy_per_sample(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """(B,) cross-entropies for integer labels."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, labels.long()[:, None])[:, 0]
    return lse - target


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    logp = torch.mean(cross_entropy_per_sample(logits, labels))
    p = torch.exp(-logp)
    return (1.0 - p) ** gamma * logp


def focal_loss_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                          gamma: float = 2.0) -> torch.Tensor:
    ce = cross_entropy_per_sample(logits, labels)
    p = torch.exp(-ce)
    return torch.mean((1.0 - p) ** gamma * ce)


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(cross_entropy_per_sample(logits, labels))


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    """Fraction of rows whose label is among the k largest logits; k is
    clamped to the class count."""
    k = min(k, logits.shape[-1])
    idx = torch.topk(logits, k, dim=-1).indices
    hit = (idx == labels.long()[:, None]).any(dim=-1)
    return hit.float().mean()
