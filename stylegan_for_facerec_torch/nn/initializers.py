"""Seeded weight initializers with the JAX package's distributions.

Every draw takes an explicit ``torch.Generator``, so a model built from a
seed has the same weights on every device. The values differ from the JAX
package's (another generator); the distributions are the same.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _fans(t: torch.Tensor):
    """fan_in, fan_out of a torch-layout weight: (out, in) or (O, I, kh, kw)."""
    rf = math.prod(t.shape[2:])
    return t.shape[1] * rf, t.shape[0] * rf


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator):
    fan_in, fan_out = _fans(t)
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-a, a, generator=generator)


@torch.no_grad()
def kaiming_uniform_(t: torch.Tensor, generator: torch.Generator,
                     a: float = math.sqrt(5)):
    """torch's default conv/linear weight init (kaiming uniform, a=sqrt(5))."""
    fan_in, _ = _fans(t)
    bound = math.sqrt(2.0 / (1 + a * a)) * math.sqrt(3.0 / fan_in)
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def uniform_fanin_bias_(t: torch.Tensor, fan_in: int,
                        generator: torch.Generator):
    """torch's default bias init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return t.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def normal_(t: torch.Tensor, generator: torch.Generator, std: float = 1.0):
    return t.normal_(0.0, std, generator=generator)


@torch.no_grad()
def init_conv_xavier_(conv: nn.Conv2d, generator: torch.Generator):
    """The IR-SE convs: xavier-uniform weight, zero bias."""
    xavier_uniform_(conv.weight, generator)
    if conv.bias is not None:
        conv.bias.zero_()


@torch.no_grad()
def init_conv_torch_default_(conv: nn.Conv2d, generator: torch.Generator):
    """The map2style convs: torch's default conv init, drawn from
    ``generator``."""
    kaiming_uniform_(conv.weight, generator)
    if conv.bias is not None:
        uniform_fanin_bias_(conv.bias, _fans(conv.weight)[0], generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight of ``model`` from ``generator``: each module of the
    port that owns random weights has an ``init_weights_(generator)`` method
    for its own and its direct torch children's; BatchNorm and PReLU keep
    torch's constant init."""
    for m in model.modules():
        fn = getattr(m, "init_weights_", None)
        if fn is not None:
            fn(generator)
    return model
