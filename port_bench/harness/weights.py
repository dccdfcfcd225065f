"""Seeds and weights made on the device from ``--seed``.

``derive(seed, *tags)`` gives each draw of a run its own 60-bit seed, so
that two draws never share a generator stream and any ``--seed`` (also
past 32 bits) works. ``draw(table, seed, device)`` makes every weight of
a reference's weight table from one normal draw on the device, each
slice then scaled and shifted to its (mean, std): one large call, in the
order of the table.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch


def derive(seed: int, *tags) -> int:
    text = ":".join(str(t) for t in (seed, *tags))
    return int(hashlib.sha256(text.encode()).hexdigest()[:15], 16)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(torch.device(device)).manual_seed(
        derive(seed, *tags))


def draw(table: List[Tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} of every row (name, shape, dtype, (mean, std)
    or None) of ``table``; a row without a rule is zeros of its dtype."""
    sizes = [math.prod(shape) for _, shape, _, rule in table
             if rule is not None]
    flat = torch.empty(sum(sizes), device=device).normal_(
        generator=generator(device, seed, "weights"))
    out, off = {}, 0
    for name, shape, dtype, rule in table:
        if rule is None:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        mean, std = rule
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    return out
