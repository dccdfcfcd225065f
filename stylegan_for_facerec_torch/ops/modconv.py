"""Style-modulated convolution (StyleGAN2) in the scaled-activation form:

    y[b] = dcoef[b] * conv(x[b] * styles[b], weight)

with ``dcoef[b, o] = rsqrt(sum_i styles[b, i]^2 * sum_k weight[o, i, k]^2
+ eps)``: one shared-weight convolution plus two per-sample scalings, equal
to the per-sample-weight grouped convolution up to float association.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor, padding: int = 0,
                     demodulate: bool = True,
                     eps: float = 1e-8) -> torch.Tensor:
    """x: (N, I, H, W); weight: (O, I, kh, kw); styles: (N, I)."""
    x_mod = x * styles.to(x.dtype)[:, :, None, None]
    y = F.conv2d(x_mod, weight.to(x.dtype), padding=padding)
    if demodulate:
        w_sq = weight.float().square().sum(dim=(2, 3))          # (O, I)
        denom = styles.float().square() @ w_sq.t() + eps          # (N, O)
        y = y * torch.rsqrt(denom).to(y.dtype)[:, :, None, None]
    return y
