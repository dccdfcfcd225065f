"""Frechet distance between two feature distributions: stage 1's FID.

The port's copy of ``stylegan_for_facerec_tpu/eval/fid.py``, in numpy:
the statistics and the matrix square roots run on the host in float64;
only the embedding forward runs on the card. The stage-1 CLI takes its
features from an IR-SE-50 (``models.irse``); real-Inception FID waits for
an InceptionV3 port.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def gaussian_stats(feats) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mu (D,), cov (D, D)) in float64."""
    x = np.asarray(feats, np.float64)
    if x.ndim != 2 or x.shape[0] < 2:
        raise ValueError(f"need (N>=2, D) features, got {x.shape}")
    mu = x.mean(axis=0)
    xc = x - mu
    return mu, xc.T @ xc / (x.shape[0] - 1)


def _sqrtm_psd(a: np.ndarray) -> np.ndarray:
    """Square root of a symmetric PSD matrix by eigendecomposition."""
    w, v = np.linalg.eigh(a)
    return (v * np.sqrt(np.clip(w, 0.0, None))) @ v.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """d^2 = |mu1 - mu2|^2 + tr(c1 + c2 - 2 (c1^1/2 c2 c1^1/2)^1/2), the
    symmetric form (no square root of the non-symmetric c1 c2)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    s1 = _sqrtm_psd(cov1)
    inner = s1 @ cov2 @ s1
    ev = np.clip(np.linalg.eigvalsh((inner + inner.T) / 2.0), 0.0, None)
    d2 = (float(np.sum((mu1 - mu2) ** 2)) + float(np.trace(cov1))
          + float(np.trace(cov2)) - 2.0 * float(np.sqrt(ev).sum()))
    return max(d2, 0.0)


def embedding_fid(embed_fn: Callable, real_images, fake_images,
                  batch_size: int = 64) -> float:
    """FID between two image sets in ``embed_fn``'s feature space.
    ``embed_fn(images)`` takes a chunk of up to ``batch_size`` images (the
    ragged tail included) and returns (B, D) features, a numpy array or a
    tensor on any device."""
    def feats(images):
        out = []
        for i in range(0, len(images), batch_size):
            f = embed_fn(images[i: i + batch_size])
            if hasattr(f, "detach"):
                f = f.detach().float().cpu().numpy()
            out.append(np.asarray(f))
        return np.concatenate(out, axis=0)

    mu_r, cov_r = gaussian_stats(feats(real_images))
    mu_f, cov_f = gaussian_stats(feats(fake_images))
    return frechet_distance(mu_r, cov_r, mu_f, cov_f)
