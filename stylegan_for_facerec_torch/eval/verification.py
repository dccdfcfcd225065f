"""Face-verification metrics: the 10-fold best-threshold accuracy protocol,
a numpy copy of ``stylegan_for_facerec_tpu/eval/verification.py`` (the
JAX package's ``eval`` package imports jax; this module imports numpy
only).

``evaluate`` takes embeddings whose even and odd rows form the pairs and
sweeps the thresholds arange(0, 4, 0.01) over squared L2 distances: the
whole sweep is one boolean (thresholds x pairs) matrix, and the folds are
sklearn ``KFold(shuffle=False)``'s contiguous splits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kfold_indices(n: int, n_folds: int):
    """sklearn KFold(shuffle=False) splits: first n % n_folds folds have
    size n//n_folds + 1."""
    sizes = np.full(n_folds, n // n_folds, dtype=int)
    sizes[: n % n_folds] += 1
    stops = np.cumsum(sizes)
    starts = stops - sizes
    return [(np.r_[np.arange(0, s), np.arange(e, n)], np.arange(s, e))
            for s, e in zip(starts, stops)]


def calculate_accuracy(threshold: float, dist: np.ndarray,
                       actual_issame: np.ndarray):
    predict = dist < threshold
    tp = np.sum(predict & actual_issame)
    fp = np.sum(predict & ~actual_issame)
    tn = np.sum(~predict & ~actual_issame)
    fn = np.sum(~predict & actual_issame)
    tpr = 0.0 if tp + fn == 0 else tp / (tp + fn)
    fpr = 0.0 if fp + tn == 0 else fp / (fp + tn)
    acc = (tp + tn) / dist.size
    return tpr, fpr, acc


def calculate_roc(thresholds: np.ndarray, embeddings1: np.ndarray,
                  embeddings2: np.ndarray, actual_issame: np.ndarray,
                  nrof_folds: int = 10, pca: int = 0):
    """Per fold: the best train threshold (the FIRST maximum, as
    np.argmax), the test accuracy at it, and the mean tpr/fpr curves.
    ``pca > 0`` fits a PCA on each train fold (sklearn) and recomputes
    the distances on the transformed, L2-normalized embeddings."""
    issame = np.asarray(actual_issame, bool)
    n = min(len(issame), embeddings1.shape[0])
    thr = np.asarray(thresholds, np.float64)

    def masks_for(dist):
        predict = dist[None, :] < thr[:, None]            # (T, N)
        return (predict & issame[None, :n],
                predict & ~issame[None, :n],
                predict == issame[None, :n])

    if pca == 0:
        dist = np.sum(np.square(embeddings1[:n] - embeddings2[:n]), axis=1)
        is_tp, is_fp, correct = masks_for(dist)

    tprs = np.zeros((nrof_folds, len(thr)))
    fprs = np.zeros((nrof_folds, len(thr)))
    accuracy = np.zeros(nrof_folds)
    best_thresholds = np.zeros(nrof_folds)

    for f, (train, test) in enumerate(kfold_indices(n, nrof_folds)):
        if pca > 0:
            from sklearn.decomposition import PCA
            fit = np.concatenate([embeddings1[train], embeddings2[train]],
                                 axis=0)
            model = PCA(n_components=pca)
            model.fit(fit)
            e1 = model.transform(embeddings1[:n])
            e2 = model.transform(embeddings2[:n])
            e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
            e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
            dist = np.sum(np.square(e1 - e2), axis=1)
            is_tp, is_fp, correct = masks_for(dist)
        acc_train = correct[:, train].mean(axis=1)
        best = int(np.argmax(acc_train))
        best_thresholds[f] = thr[best]
        pos_t = issame[test].sum()
        neg_t = (~issame[test]).sum()
        tp = is_tp[:, test].sum(axis=1)
        fp = is_fp[:, test].sum(axis=1)
        tprs[f] = 0.0 if pos_t == 0 else tp / pos_t
        fprs[f] = 0.0 if neg_t == 0 else fp / neg_t
        accuracy[f] = correct[best, test].mean()

    return tprs.mean(0), fprs.mean(0), accuracy, best_thresholds


def calculate_val(thresholds: np.ndarray, embeddings1: np.ndarray,
                  embeddings2: np.ndarray, actual_issame: np.ndarray,
                  far_target: float, nrof_folds: int = 10):
    """Threshold at the FAR target by linear interpolation (``np.interp``
    over the non-decreasing FAR curve) on the train fold; VAL and FAR on
    the test fold. ``evaluate`` does not call it."""
    issame = np.asarray(actual_issame, bool)
    n = min(len(issame), embeddings1.shape[0])
    dist = np.sum(np.square(embeddings1[:n] - embeddings2[:n]), axis=1)
    thr = np.asarray(thresholds, np.float64)

    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    for f, (train, test) in enumerate(kfold_indices(n, nrof_folds)):
        far_train = np.array([
            _val_far(t, dist[train], issame[train])[1] for t in thr])
        if np.max(far_train) >= far_target:
            threshold = float(np.interp(far_target, far_train, thr))
        else:
            threshold = 0.0
        val[f], far[f] = _val_far(threshold, dist[test], issame[test])
    return float(val.mean()), float(val.std()), float(far.mean())


def _val_far(threshold, dist, issame):
    predict = dist < threshold
    ta = np.sum(predict & issame)
    fa = np.sum(predict & ~issame)
    n_same = issame.sum()
    n_diff = (~issame).sum()
    return (ta / n_same if n_same else 0.0,
            fa / n_diff if n_diff else 0.0)


def evaluate(embeddings: np.ndarray, actual_issame, nrof_folds: int = 10):
    """Pairs interleaved even/odd, thresholds arange(0, 4, 0.01); returns
    (tpr, fpr, per-fold accuracy, per-fold best threshold)."""
    thresholds = np.arange(0, 4, 0.01)
    e1 = embeddings[0::2]
    e2 = embeddings[1::2]
    tpr, fpr, accuracy, best = calculate_roc(
        thresholds, e1, e2, np.asarray(actual_issame), nrof_folds)
    return tpr, fpr, accuracy, best
