"""Optimizers, schedules and masks of the training stages.

Stage 3 (``stylegan_for_facerec_tpu/train/optim.py``'s SGD half): torch's
own ``torch.optim.SGD(momentum=0.9, nesterov=False)``, whose update
(g += wd p; buf = m buf + g; p -= lr buf) is ``sgd_torch``'s; the
BatchNorm weight-decay exemption as parameter groups
(``batchnorm_decay_mask``, ``sgd_param_groups``); ``Stage3Schedule``;
``freeze_mask_for``, whose frozen parameters the trainer takes out of
autograd, so that they get no gradient, no decay and no momentum change;
``increasing_layer_decay_mask``.

Stage 2, Ranger: gradient centralisation -> RAdam -> scale by -lr ->
Lookahead(k=6, alpha=0.5), betas (0.95, 0.999), eps 1e-5.

Step for step the JAX chain ``stylegan_for_facerec_tpu/train/optim.py::
ranger`` (``optax.scale_by_radam`` inside):

  * gradient centralisation subtracts the mean over every dim but dim 0
    from each gradient of ndim > 1 (the port's convolutions are OIHW and
    its dense weights (out, in), so dim 0 is the output);
  * RAdam: m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2,
    rho_inf = 2 / (1 - b2) - 1, rho_t = rho_inf - 2 t b2^t / (1 - b2^t);
    the update is r_t m_hat / (sqrt(v_hat) + eps) when rho_t >= 5, else the
    bias-corrected m_hat, with
    r_t = sqrt((rho_t - 4)(rho_t - 2) rho_inf / ((rho_inf - 4)(rho_inf - 2)
    rho_t));
  * u = -lr * update; every k-th step the slow weights move alpha of the
    way to p + u and p is set to them, else p += u. The slow weights are
    optimizer state, taken from p at the first step.

rho_t sits near the threshold at t = 5 and 6, where one f32 rounding of
b2^t moves r_t by about 1 %. The step constants (b^t, the bias
corrections, rho_t, r_t) are therefore computed on the host in float32 the
way optax computes them (b^t by square-and-multiply), so that the port
takes the same steps as the JAX package, not merely close ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

_F32 = np.float32


def batchnorm_decay_mask(module: nn.Module) -> Dict[str, bool]:
    """{parameter name: decays}: BatchNorm weights and biases are exempt,
    every other parameter (convolutions, Linears, PReLU) decays; split by
    module class."""
    bn = set()
    for name, mod in module.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            bn.update(f"{name}.{k}" if name else k
                      for k, _ in mod.named_parameters(recurse=False))
    return {k: k not in bn for k, _ in module.named_parameters()}


def sgd_param_groups(named_params: Iterable[Tuple[str, torch.Tensor]],
                     decay_mask: Dict[str, bool],
                     weight_decay: float) -> List[Dict]:
    """Two ``torch.optim.SGD`` parameter groups: the decaying parameters
    with ``weight_decay``, the exempt ones with 0."""
    named = list(named_params)
    return [{"params": [p for k, p in named if decay_mask[k]],
             "weight_decay": weight_decay},
            {"params": [p for k, p in named if not decay_mask[k]],
             "weight_decay": 0.0}]


@dataclasses.dataclass(frozen=True)
class Stage3Schedule:
    """lr(step): linear warmup over ``warmup_batches``, then /1.5 from the
    first step of each stage epoch in ``stages`` on (epoch >= s). Computed
    in float32, as the JAX package's jnp schedule is."""

    base_lr: float = 0.03
    warmup_batches: int = 0
    steps_per_epoch: int = 1
    stages: Sequence[int] = ()
    decay_factor: float = 1.5

    def __call__(self, step: int) -> float:
        epoch = int(step) // self.steps_per_epoch
        n_decays = sum(1 for s in self.stages if epoch >= s)
        lr = _F32(self.base_lr) / _F32(_F32(self.decay_factor) ** n_decays)
        if self.warmup_batches > 0 and step < self.warmup_batches:
            lr = (_F32(self.base_lr) * _F32(step + 1)
                  / _F32(self.warmup_batches))
        return float(_F32(lr))


def freeze_mask_for(names: Iterable[str],
                    frozen_prefixes: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: trains}: False under any of the dotted prefixes
    (the stage-3 freeze of the encoder body in the first epochs)."""
    return {k: not any(k == p or k.startswith(p + ".")
                       for p in frozen_prefixes) for k in names}


def increasing_layer_decay_mask(names: Sequence[str],
                                first_layer_lr: float = 0.0
                                ) -> Dict[str, float]:
    """{parameter name: learning-rate ratio}: the 'weight' parameters are
    counted in order; a weight and the parameters after it up to the next
    weight ('bias') get first_layer_lr + k / n (1 - first_layer_lr) for
    the k-th of n weights, so early layers learn slower; any other name
    keeps 1."""
    leaves = [k.split(".")[-1] for k in names]
    n_weights = leaves.count("weight")
    out, cur = {}, 0
    for k, leaf in zip(names, leaves):
        if leaf == "weight":
            cur += 1
        if leaf in ("weight", "bias") and n_weights:
            out[k] = first_layer_lr + cur / n_weights * (1.0 - first_layer_lr)
        else:
            out[k] = 1.0
    return out


def _f32_pow(b: float, t: int) -> np.float32:
    """b^t in float32 by square-and-multiply, as XLA's integer power."""
    x, r = _F32(b), _F32(1.0)
    while t:
        if t & 1:
            r = _F32(r * x)
        x = _F32(x * x)
        t >>= 1
    return r


def radam_constants(t: int, b1: float, b2: float, threshold: float = 5.0):
    """(1 - b1^t, 1 - b2^t, r_t or None when not rectified) in float32."""
    bc1 = _F32(1.0) - _f32_pow(b1, t)
    b2t = _f32_pow(b2, t)
    bc2 = _F32(1.0) - b2t
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    ro = _F32(_F32(ro_inf) - _F32(_F32(2 * t) * b2t) / bc2)
    if not ro >= threshold:
        return float(bc1), float(bc2), None
    num = _F32(_F32(_F32(ro - _F32(4.0)) * _F32(ro - _F32(2.0)))
               * _F32(ro_inf))
    den = _F32(_F32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro)
    return float(bc1), float(bc2), float(np.sqrt(_F32(num / den)))


class Ranger(torch.optim.Optimizer):
    """RAdam + Lookahead + gradient centralisation. Parameters whose
    ``grad`` is None are skipped, as torch optimizers do."""

    def __init__(self, params: Iterable, lr: float = 1e-4,
                 betas=(0.95, 0.999), eps: float = 1e-5, k: int = 6,
                 alpha: float = 0.5):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, k=k,
                                      alpha=alpha))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if g.dim() > 1:
                    g = g - g.mean(dim=tuple(range(1, g.dim())), keepdim=True)
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                    st["slow"] = p.detach().clone()
                st["step"] += 1
                t = st["step"]
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).add_(g * g, alpha=1.0 - b2)
                bc1, bc2, r = radam_constants(t, b1, b2)
                m_hat = m / bc1
                if r is None:
                    u = m_hat
                else:
                    u = (r * m_hat) / (torch.sqrt(v / bc2) + group["eps"])
                u = u * -group["lr"]
                if t % group["k"] == 0:
                    slow = st["slow"]
                    slow.add_(p + u - slow, alpha=group["alpha"])
                    u = slow - p
                p.add_(u)
        return loss
