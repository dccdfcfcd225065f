"""The numbers that decide ``correct``.

Training: each compared step's loss against the reference's (relative),
and two gaps of norms taken leaf by leaf: the gap between the program's
norm of a leaf and the reference's, over the larger of the reference's
norm of that leaf and the median leaf's, the worst leaf counted. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out of both, since round-off alone moves them (a Linear's bias
before BatchNorm).

Answers (images, latents): the relative L2 error of each answer against
the reference's, the worst answer counted.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Sequence, Set, Tuple

import torch


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: float64 L2 norm}, read in one transfer."""
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().double().norm()
                        for k in names]).tolist()
    return dict(zip(names, vals))


def counted_leaves(ref_grad_norms: Dict[str, float],
                   share: float = 1e-3) -> Set[str]:
    med = statistics.median(ref_grad_norms.values())
    return {k for k, v in ref_grad_norms.items() if v >= share * med}


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             leaves: Iterable[str]) -> Tuple[float, str]:
    """(worst gap, its leaf)."""
    leaves = sorted(leaves)
    med = statistics.median(ref[k] for k in leaves)
    worst, where = 0.0, ""
    for k in leaves:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if not gap <= worst:          # NaN counts as worst
            worst, where = gap, k
    return worst, where


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return max(g if g == g else float("inf") for g in gaps)


def answer_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst relative L2 error over the leading (answer) dim."""
    got = got.float().reshape(got.shape[0], -1)
    want = want.float().reshape(want.shape[0], -1)
    err = (got - want).norm(dim=1) / want.norm(dim=1).clamp_min(1e-30)
    err = torch.where(torch.isfinite(err), err, torch.full_like(err, 1e30))
    return float(err.max())

