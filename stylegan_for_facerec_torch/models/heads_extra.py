"""The margin heads beyond the stage-3 trainer's, as
``stylegan_for_facerec_tpu/models/heads_extra.py``: ``AMSoftmaxV2``,
``ArcNegFace``, ``CircleLoss``, ``MagFace``, ``MVSoftmax``, ``NPCFace`` and
``SSTPrototype``. Library modules: the trainer uses ``models.heads``.

Contract: ``head(features, labels) -> scaled logits`` (N, C); ``MagFace``
also returns its (N, 1) magnitude regularizer; ``SSTPrototype`` takes a
semi-siamese batch. Each head draws its weights in its constructor from
seed 0 on the CPU; ``init_weights_(generator)`` draws them again. The
parameter names and layouts are the JAX package's: ``weight`` (D, C),
except ``ArcNegFace.weight`` (C, D) and ``NPCFace.kernel`` (D, C).
``SSTPrototype`` carries its queue in buffers that each forward updates in
place, without gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn


def _normalize(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=eps)


@torch.no_grad()
def _renorm_init_(t: torch.Tensor, generator: torch.Generator, dim: int):
    """torch's ``uniform_(-1, 1).renorm_(2, dim, 1e-5).mul_(1e5)``: unit
    vectors along ``dim`` (vectors of norm up to 1e-5 scaled by 1e5)."""
    k = torch.empty(t.shape).uniform_(-1.0, 1.0, generator=generator)
    n = torch.linalg.norm(k, dim=dim, keepdim=True)
    return t.copy_(torch.where(n > 1e-5, k / n, k * 1e5))


def _one_hot(labels: torch.Tensor, n: int, like: torch.Tensor):
    return F.one_hot(labels.long(), n).to(like.dtype)


class _ClassColumns(nn.Module):
    """A head whose (D, C) class matrix (``weight``, or ``kernel``) has unit
    columns at init."""

    param_name = "weight"

    def __init__(self, feat_dim: int, num_class: int):
        super().__init__()
        self.feat_dim, self.num_class = feat_dim, num_class
        self.register_parameter(self.param_name, nn.Parameter(
            torch.empty(feat_dim, num_class)))
        self.init_weights_(torch.Generator().manual_seed(0))

    def init_weights_(self, generator: torch.Generator):
        _renorm_init_(getattr(self, self.param_name), generator, dim=0)

    def cosine(self, feats: torch.Tensor) -> torch.Tensor:
        return _normalize(feats) @ _normalize(getattr(self, self.param_name),
                                              dim=0)


class AMSoftmaxV2(_ClassColumns):
    """cos - m on the target, times s (s 32, m 0.35)."""

    def __init__(self, feat_dim: int, num_class: int, margin: float = 0.35,
                 scale: float = 32.0):
        super().__init__(feat_dim, num_class)
        self.margin, self.scale = margin, scale

    def forward(self, feats, labels):
        cos = torch.clamp(self.cosine(feats), -1, 1)
        oh = _one_hot(labels, self.num_class, cos)
        return torch.where(oh > 0, cos - self.margin, cos) * self.scale


class ArcNegFace(nn.Module):
    """The arc margin on the target; each negative re-weighted by a
    detached Gaussian of its distance to the target's margined logit."""

    def __init__(self, feat_dim: int, num_class: int, margin: float = 0.5,
                 scale: float = 64.0, alpha: float = 1.2, sigma: float = 2.0):
        super().__init__()
        self.feat_dim, self.num_class = feat_dim, num_class
        self.margin, self.scale, self.alpha, self.sigma = (margin, scale,
                                                           alpha, sigma)
        self.weight = nn.Parameter(torch.empty(num_class, feat_dim))
        self.init_weights_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        stdv = 1.0 / math.sqrt(self.feat_dim)
        self.weight.copy_(torch.empty(self.weight.shape).uniform_(
            -stdv, stdv, generator=generator))

    def forward(self, feats, labels):
        thresh = math.cos(math.pi - self.margin)
        mm = math.sin(math.pi - self.margin) * self.margin
        cos = _normalize(feats) @ _normalize(self.weight).t()
        oh = _one_hot(labels, self.num_class, cos)
        target = torch.sum(cos * oh, dim=1, keepdim=True)
        a_t = torch.where(
            target > thresh,
            torch.cos(torch.arccos(torch.clamp(target, -1, 1)) + self.margin),
            target - mm)
        t_scale = (self.alpha * torch.exp(
            -torch.square(cos - a_t) / self.sigma)).detach()
        out = oh * a_t + (1 - oh) * (t_scale * cos + t_scale - 1)
        return self.scale * out


class CircleLoss(_ClassColumns):
    """Circle loss in its classification form (margin 0.25, gamma 256)."""

    def __init__(self, feat_dim: int, num_class: int, margin: float = 0.25,
                 gamma: float = 256.0):
        super().__init__(feat_dim, num_class)
        self.margin, self.gamma = margin, gamma

    def forward(self, feats, labels):
        m = self.margin
        cos = torch.clamp(self.cosine(feats), -1, 1)
        oh = _one_hot(labels, self.num_class, cos)
        sg = cos.detach()
        alpha_p = torch.clamp((1 + m) - sg, min=0.0)
        alpha_n = torch.clamp(sg + m, min=0.0)
        logit_p = alpha_p * (cos - (1 - m))
        logit_n = alpha_n * (cos - m)
        return (oh * logit_p + (1 - oh) * logit_n) * self.gamma


class MagFace(_ClassColumns):
    """A margin that grows with the feature's magnitude (clipped to [l_a,
    u_a]); returns (logits, lamda * g(|x|)), the magnitude regularizer
    g(a) = a / u_a^2 + 1 / a per sample."""

    def __init__(self, feat_dim: int, num_class: int, margin_am: float = 0.0,
                 scale: float = 32.0, l_a: float = 10.0, u_a: float = 110.0,
                 l_margin: float = 0.45, u_margin: float = 0.8,
                 lamda: float = 20.0):
        super().__init__(feat_dim, num_class)
        self.margin_am, self.scale = margin_am, scale
        self.l_a, self.u_a = l_a, u_a
        self.l_margin, self.u_margin, self.lamda = l_margin, u_margin, lamda

    def forward(self, feats, labels):
        x_norm = torch.clamp(torch.linalg.norm(feats, dim=1, keepdim=True),
                             self.l_a, self.u_a)
        ada_m = ((self.u_margin - self.l_margin) / (self.u_a - self.l_a)
                 * (x_norm - self.l_a) + self.l_margin)
        loss_g = x_norm / (self.u_a ** 2) + 1.0 / x_norm
        cos = torch.clamp(self.cosine(feats), -1, 1)
        sin = torch.sqrt(torch.clamp(1.0 - torch.square(cos), 0, 1))
        cos_t_m = cos * torch.cos(ada_m) - sin * torch.sin(ada_m)
        min_cos = torch.cos(math.pi - ada_m)
        cos_t_m = torch.where(cos > min_cos, cos_t_m, cos - self.margin_am)
        oh = _one_hot(labels, self.num_class, cos)
        out = torch.where(oh > 0, cos_t_m, cos) * self.scale
        return out, self.lamda * loss_g


class MVSoftmax(_ClassColumns):
    """Mis-classified-vector softmax: negatives above the margined target
    become mv_weight * cos + mv_weight - 1; the target gets the arc margin
    (or, with ``is_am``, the additive one)."""

    def __init__(self, feat_dim: int, num_class: int, is_am: bool = False,
                 margin: float = 0.35, mv_weight: float = 1.12,
                 scale: float = 32.0):
        super().__init__(feat_dim, num_class)
        self.is_am, self.margin = is_am, margin
        self.mv_weight, self.scale = mv_weight, scale

    def forward(self, feats, labels):
        cos = self.cosine(feats)
        oh = _one_hot(labels, self.num_class, cos)
        gt = torch.sum(cos * oh, dim=1, keepdim=True)
        if self.is_am:
            mask = cos > gt - self.margin
            final_gt = torch.where(gt > self.margin, gt - self.margin, gt)
        else:
            sin_t = torch.sqrt(torch.clamp(1.0 - torch.square(gt), 0, 1))
            cos_t_m = (gt * math.cos(self.margin)
                       - sin_t * math.sin(self.margin))
            mask = cos > cos_t_m
            final_gt = torch.where(gt > 0.0, cos_t_m, gt)
        hard = self.mv_weight * cos + self.mv_weight - 1.0
        out = torch.where(mask, hard, cos)
        return torch.where(oh > 0, final_gt, out) * self.scale


class NPCFace(_ClassColumns):
    """Negative-positive cooperation: hard negatives become t cos + a, and
    the target's margin grows with the mean of its hard negatives'
    cosines (detached)."""

    param_name = "kernel"

    def __init__(self, feat_dim: int = 512, num_class: int = 86876,
                 margin: float = 0.5, scale: float = 64.0, m0: float = 0.40,
                 m1: float = 0.20, t: float = 1.10, a: float = 0.20):
        super().__init__(feat_dim, num_class)
        self.margin, self.scale = margin, scale
        self.m0, self.m1, self.t, self.a = m0, m1, t, a

    def forward(self, feats, labels):
        cos = torch.clamp(self.cosine(feats), -1, 1)
        oh = _one_hot(labels, self.num_class, cos)
        gt = torch.sum(cos * oh, dim=1, keepdim=True)
        sin_t = torch.sqrt(torch.clamp(1.0 - torch.square(gt), 0, 1))
        cos_t_m = gt * math.cos(self.margin) - sin_t * math.sin(self.margin)
        hard_mask = ((cos > cos_t_m).to(cos.dtype) * (1 - oh)).detach()
        sum_hard = torch.sum(cos * hard_mask, dim=1, keepdim=True)
        cnt_hard = torch.clamp(torch.sum(hard_mask, dim=1, keepdim=True), 1,
                               self.num_class)
        newm = self.m0 + self.m1 * (sum_hard / cnt_hard).detach()
        final_gt = torch.where(
            gt > 0, gt * torch.cos(newm) - sin_t * torch.sin(newm), gt)
        out = torch.where(cos > cos_t_m, self.t * cos + self.a, cos)
        return torch.where(oh > 0, final_gt, out) * self.scale


class SSTPrototype(nn.Module):
    """Semi-siamese training's queue of prototypes: ``queue`` (feat_dim,
    queue_size) of unit columns, the write cursor ``index`` and the
    ``labels`` of the written columns (-1 unwritten).

    ``forward(p1, g2, p2, g1, cur_ids, generator=None, coin=None)``: the
    batch's columns are ``(index + arange(bs)) % queue_size`` (wrapping
    around, so any batch size keeps columns and labels in step); each probe
    p is scored against the queue with the other view's gallery g in those
    columns (queue and g detached), with the margin of ``loss_type``,
    times ``scale``. Then the columns take g1 or g2, by a fair coin drawn
    from ``generator`` (a CPU generator gives the card and the CPU the same
    draw) unless ``coin`` (True: g1) is given, and the labels take
    ``cur_ids``. Returns (logits1, logits2, column labels)."""

    def __init__(self, feat_dim: int = 512, queue_size: int = 16384,
                 scale: float = 30.0, loss_type: str = "softmax",
                 margin: float = 0.0):
        super().__init__()
        if loss_type not in ("softmax", "am_softmax", "arc_softmax"):
            raise ValueError(f"loss_type {loss_type!r}: "
                             f"softmax|am_softmax|arc_softmax")
        self.feat_dim, self.queue_size = feat_dim, queue_size
        self.scale, self.loss_type, self.margin = scale, loss_type, margin
        self.register_buffer("queue", torch.empty(feat_dim, queue_size))
        self.register_buffer("index", torch.zeros((), dtype=torch.long))
        self.register_buffer("labels", torch.full((queue_size,), -1,
                                                  dtype=torch.long))
        self.init_weights_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        _renorm_init_(self.queue, generator, dim=0)
        self.queue.copy_(_normalize(self.queue, dim=0))
        self.index.zero_()
        self.labels.fill_(-1)

    def _add_margin(self, cos, labels):
        cos = torch.clamp(cos, -1, 1)
        oh = _one_hot(labels, self.queue_size, cos)
        gt = torch.sum(cos * oh, dim=1, keepdim=True)
        if self.loss_type == "am_softmax":
            return torch.where(oh > 0, gt - self.margin, cos)
        if self.loss_type == "arc_softmax":
            sin_t = torch.sqrt(torch.clamp(1.0 - torch.square(gt), 0, 1))
            gt_m = gt * math.cos(self.margin) - sin_t * math.sin(self.margin)
            return torch.where(oh > 0, gt_m, cos)
        return cos

    def forward(self, p1, g2, p2, g1, cur_ids,
                generator: Optional[torch.Generator] = None,
                coin: Union[bool, torch.Tensor, None] = None):
        p1, g2 = _normalize(p1), _normalize(g2).detach()
        p2, g1 = _normalize(p2), _normalize(g1).detach()
        bs = p1.shape[0]
        cols = (self.index + torch.arange(bs, device=p1.device)) \
            % self.queue_size

        def theta(p, g):
            q = self.queue.index_copy(1, cols, g.t())
            return self._add_margin(p @ q, cols) * self.scale

        out1, out2 = theta(p1, g2), theta(p2, g1)
        if coin is None:
            if generator is None:
                raise ValueError("SSTPrototype draws its coin from an "
                                 "explicit torch.Generator: pass generator "
                                 "or coin")
            coin = torch.rand((), generator=generator,
                              device=generator.device) < 0.5
        coin = torch.as_tensor(coin, device=p1.device)
        with torch.no_grad():
            self.queue.index_copy_(1, cols, torch.where(coin, g1, g2).t())
            self.labels.index_copy_(0, cols, cur_ids.to(self.labels))
            self.index.copy_((self.index + bs) % self.queue_size)
        return out1, out2, cols
