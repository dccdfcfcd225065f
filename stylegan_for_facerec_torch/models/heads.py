"""Margin-softmax classification heads, as
``stylegan_for_facerec_tpu/models/heads.py``.

Contract: ``head(features, labels) -> scaled logits`` (N, C); the training
loss (focal CE) goes on top. The margin math is also exposed as functions
of the cosine block, which ``train.stage3`` uses directly. The stateful
heads keep their state in buffers that each forward updates, as the
reference torch heads mutate theirs: SphereFace's ``iter``, AdaCos's
``scale`` and CurricularFace's ``t``. Each head draws its weights in its
constructor from seed 0; ``init_weights_(generator)`` draws them again.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.initializers import normal_, xavier_uniform_


def _normalize(x: torch.Tensor, dim: int = -1,
               eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics: x / max(||x||, eps)."""
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=eps)


def cosine_logits(features: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """cos(theta) between L2-normalized features (N, D) and class weights
    (C, D) -> (N, C)."""
    return _normalize(features) @ _normalize(weight).t()


def arcface_margin(cosine: torch.Tensor, one_hot: torch.Tensor,
                   s: float = 64.0, m: float = 0.50,
                   easy_margin: bool = False,
                   eps: float = 1e-10) -> torch.Tensor:
    """cos(theta + m) on the target class, with the sine clamped to
    [eps, 1 - eps] and, past theta = pi - m, ``cos - m sin(pi - m)``."""
    cos_m, sin_m = math.cos(m), math.sin(m)
    th = math.cos(math.pi - m)
    mm = math.sin(math.pi - m) * m
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, eps, 1 - eps))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        phi = torch.where(cosine > th, phi, cosine - mm)
    return (one_hot * phi + (1.0 - one_hot) * cosine) * s


def cosface_margin(cosine: torch.Tensor, one_hot: torch.Tensor,
                   s: float = 64.0, m: float = 0.50) -> torch.Tensor:
    """cos(theta) - m on the target class."""
    return (one_hot * (cosine - m) + (1.0 - one_hot) * cosine) * s


def margin_logits(kind: str, cosine: torch.Tensor, one_hot: torch.Tensor,
                  **kw) -> torch.Tensor:
    if kind == "arcface":
        return arcface_margin(cosine, one_hot, **kw)
    if kind == "cosface":
        return cosface_margin(cosine, one_hot, **kw)
    if kind == "am_softmax":
        c = torch.clamp(cosine, -1, 1)
        s = kw.get("s", 30.0)
        m = kw.get("m", 0.35)
        return torch.where(one_hot > 0, c - m, c) * s
    raise ValueError(kind)


def _one_hot(labels: torch.Tensor, n: int, like: torch.Tensor):
    return F.one_hot(labels.long(), n).to(like.dtype)


class _Head(nn.Module):
    """A head with a (C, D) xavier-uniform ``weight``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def init_weights_(self, generator: torch.Generator):
        xavier_uniform_(self.weight, generator)


class SoftmaxHead(_Head):
    """Plain linear classifier."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.init_weights_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        super().init_weights_(generator)
        self.bias.zero_()

    def forward(self, features, labels):
        return features @ self.weight.t() + self.bias


class ArcFace(_Head):
    def __init__(self, in_features: int, out_features: int, s: float = 64.0,
                 m: float = 0.50, easy_margin: bool = False,
                 eps: float = 1e-10):
        super().__init__(in_features, out_features)
        self.s, self.m, self.easy_margin, self.eps = s, m, easy_margin, eps
        self.init_weights_(torch.Generator().manual_seed(0))

    def forward(self, features, labels):
        cosine = cosine_logits(features, self.weight)
        return arcface_margin(cosine, _one_hot(labels, self.out_features,
                                               cosine),
                              self.s, self.m, self.easy_margin, self.eps)


class CosFace(_Head):
    def __init__(self, in_features: int, out_features: int, s: float = 64.0,
                 m: float = 0.50):
        super().__init__(in_features, out_features)
        self.s, self.m = s, m
        self.init_weights_(torch.Generator().manual_seed(0))

    def forward(self, features, labels):
        cosine = cosine_logits(features, self.weight)
        return cosface_margin(cosine, _one_hot(labels, self.out_features,
                                               cosine), self.s, self.m)


class SphereFace(_Head):
    """cos(m theta) with an annealed lambda; ``iter`` counts forwards."""

    def __init__(self, in_features: int, out_features: int, m: int = 4,
                 base: float = 1000.0, gamma: float = 0.12,
                 power: float = 1.0, lambda_min: float = 5.0):
        super().__init__(in_features, out_features)
        self.m, self.base, self.gamma = m, base, gamma
        self.power, self.lambda_min = power, lambda_min
        self.register_buffer("iter", torch.zeros((), dtype=torch.int32))
        self.init_weights_(torch.Generator().manual_seed(0))

    def forward(self, features, labels):
        it = self.iter + 1
        lamb = torch.clamp(self.base * (1 + self.gamma * it.float())
                           ** (-self.power), min=self.lambda_min)
        cos_t = torch.clamp(cosine_logits(features, self.weight), -1, 1)
        mforms = [
            lambda x: x * 0 + 1,
            lambda x: x,
            lambda x: 2 * x ** 2 - 1,
            lambda x: 4 * x ** 3 - 3 * x,
            lambda x: 8 * x ** 4 - 8 * x ** 2 + 1,
            lambda x: 16 * x ** 5 - 20 * x ** 3 + 5 * x,
        ]
        cos_m_t = mforms[self.m](cos_t)
        theta = torch.arccos(torch.clamp(cos_t, -1 + 1e-7, 1 - 1e-7))
        k = torch.floor(self.m * theta / math.pi)
        phi = torch.pow(-1.0, k) * cos_m_t - 2 * k
        feat_norm = torch.linalg.norm(features, dim=1, keepdim=True)
        one_hot = _one_hot(labels, self.out_features, cos_t)
        out = (one_hot * (phi - cos_t) / (1 + lamb)) + cos_t
        with torch.no_grad():
            self.iter.copy_(it)
        return out * feat_norm


class AmSoftmax(nn.Module):
    """Additive-margin softmax; ``kernel`` (D, C), columns L2-normalized
    at init (``renorm`` of columns with norm above 1e-5)."""

    def __init__(self, in_features: int, out_features: int, m: float = 0.35,
                 s: float = 30.0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.m, self.s = m, s
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.init_weights_(torch.Generator().manual_seed(0))

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator):
        k = torch.empty_like(self.kernel).uniform_(-1.0, 1.0,
                                                   generator=generator)
        norms = torch.linalg.norm(k, dim=0, keepdim=True)
        self.kernel.copy_(torch.where(norms > 1e-5, k / norms, k * 1e5))

    def forward(self, features, labels):
        kernel_norm = self.kernel / torch.clamp(
            torch.linalg.norm(self.kernel, dim=0, keepdim=True), min=1e-12)
        cos_t = torch.clamp(features @ kernel_norm, -1, 1)
        return margin_logits("am_softmax", cos_t,
                             _one_hot(labels, self.out_features, cos_t),
                             s=self.s, m=self.m)


class AdaCos(_Head):
    """Adaptively scaled cosine logits. Each forward sets ``scale`` to
    log(B_avg) / cos(min(pi/4, median target theta)) from the old scale
    (no gradient; the lower median, as ``torch.median``) and returns the
    logits times the new scale."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        self.register_buffer("scale", torch.tensor(
            math.sqrt(2) * math.log(out_features - 1), dtype=torch.float32))
        self.init_weights_(torch.Generator().manual_seed(0))

    def forward(self, features, labels):
        logits = cosine_logits(features, self.weight)
        with torch.no_grad():
            theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7,
                                             1.0 - 1e-7))
            one_hot = _one_hot(labels, self.out_features, logits)
            b = features.shape[0]
            b_avg = torch.sum(torch.where(one_hot < 1,
                                          torch.exp(self.scale * logits),
                                          torch.zeros_like(logits))) / b
            target = theta.gather(1, labels.long()[:, None])[:, 0]
            theta_med = torch.sort(target).values[(b - 1) // 2]
            self.scale.copy_(torch.log(b_avg) / torch.cos(
                torch.clamp(theta_med, max=math.pi / 4)))
        return self.scale.clone() * logits


class CurricularFace(_Head):
    """Adaptive hard-negative weighting with an EMA statistic ``t``
    (updated without gradient)."""

    def __init__(self, in_features: int, out_features: int, s: float = 64.0,
                 m: float = 0.50):
        super().__init__(in_features, out_features)
        self.s, self.m = s, m
        self.register_buffer("t", torch.zeros(()))
        self.init_weights_(torch.Generator().manual_seed(0))

    def init_weights_(self, generator: torch.Generator):
        normal_(self.weight, generator, std=0.01)

    def forward(self, features, labels):
        cos_m, sin_m = math.cos(self.m), math.sin(self.m)
        th = math.cos(math.pi - self.m)
        mm = math.sin(math.pi - self.m) * self.m
        cosine = cosine_logits(features, self.weight)
        one_hot = _one_hot(labels, self.out_features, cosine)
        target = torch.sum(cosine * one_hot, dim=1, keepdim=True)
        sin_t = torch.sqrt(torch.clamp(1.0 - target ** 2, 0, 1))
        cos_t_m = target * cos_m - sin_t * sin_m
        phi = torch.where(target > th, cos_t_m, target - mm)
        with torch.no_grad():
            self.t.copy_(0.99 * self.t + 0.01 * torch.mean(target))
        hard = torch.where(cosine > cos_t_m, cosine * (self.t + cosine),
                           cosine)
        out = one_hot * phi + (1 - one_hot) * hard
        return out * self.s


HEAD_REGISTRY = {
    "Softmax": SoftmaxHead,
    "ArcFace": ArcFace,
    "CosFace": CosFace,
    "SphereFace": SphereFace,
    "Am_softmax": AmSoftmax,
    "AdaCos": AdaCos,
    "CurricularFace": CurricularFace,
}


def build_head(name: str, in_features: int, out_features: int,
               **kw) -> nn.Module:
    if name not in HEAD_REGISTRY:
        raise ValueError(f"unknown head {name!r}; have {list(HEAD_REGISTRY)}")
    return HEAD_REGISTRY[name](in_features, out_features, **kw)
