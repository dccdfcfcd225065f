"""The RB-WebFace benchmark, as ``stylegan_for_facerec_tpu/eval/
rb_webface.py``: TPR at FPR 1e-3 and 1e-4 for each ethnic group.

  * embeddings: PIL bilinear resize to 128, centre crop 112, the backbone,
    L2 norm (no flip TTA);
  * FNMR at each threshold: the share of genuine pairs (all pairs within
    each run of 5 consecutive images, one identity) whose cosine
    similarity is below it, compared in float64 as the JAX package does;
  * FMR at each threshold: the share of impostor pairs i < j of the
    negative list whose similarity is above it, compared in float32;
  * thresholds linspace(0.3, 0.6, 20); TPR@FPR by linear interpolation of
    the (FPR, FNR) curve.

The counts run on ``device`` (the card unless the caller asks for the
CPU). The impostor sweep takes one product of a chunk of rows with
the columns from the chunk's first row on (the pairs j <= i of the chunk's
leading square masked), then one count per threshold of that (chunk, M)
block. No (thresholds, chunk, M) tensor is formed; the counts stay on the
device until the sweep ends.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

ETHNICITIES = ("African", "Asian", "Caucasian", "Indian")


def _as_f32(emb, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(emb) if not torch.is_tensor(emb)
                           else emb, dtype=torch.float32).to(device)


def genuine_similarities(pos_emb, n_names_per_grp: int = 5,
                         device: str = "cuda") -> np.ndarray:
    """The float32 cosine similarities of every genuine pair, identity by
    identity, pairs (i, j) with i < j in row-major order."""
    dev = resolve_device(device)
    emb = _as_f32(pos_emb, dev)
    n, d = emb.shape
    g = n_names_per_grp
    n_grp = n // g
    emb = emb[: n_grp * g].reshape(n_grp, g, d)
    sims = torch.einsum("gid,gjd->gij", emb, emb)
    iu, ju = np.triu_indices(g, k=1)
    return sims[:, iu, ju].reshape(-1).cpu().numpy()


def fnmr_counts(pos_emb, thresholds, n_names_per_grp: int = 5,
                device: str = "cuda") -> Tuple[np.ndarray, int]:
    """Counts of genuine-pair similarities below each threshold, and the
    number of pairs. ``pos_emb`` (N, D) unit-norm, N a multiple of the
    group size (a ragged tail is dropped)."""
    pair_sims = genuine_similarities(pos_emb, n_names_per_grp, device)
    thr = np.asarray(thresholds)
    counts = (pair_sims[None, :] < thr[:, None]).sum(axis=1)
    return counts, pair_sims.size


@torch.no_grad()
def fmr_counts(neg_emb, thresholds, chunk: int = 2048,
               device: str = "cuda") -> Tuple[np.ndarray, int]:
    """Counts of impostor-pair similarities above each threshold over all
    pairs i < j of ``neg_emb`` (N, D), and the number of pairs; ``chunk``
    rows a product on ``device``."""
    dev = resolve_device(device)
    emb = _as_f32(neg_emb, dev)
    n = emb.shape[0]
    thr = torch.as_tensor(np.asarray(thresholds), dtype=torch.float32,
                          device=dev)
    counts = torch.zeros(len(thr), dtype=torch.int64, device=dev)
    for i in range(0, n, chunk):
        rows = emb[i:i + chunk]
        c = rows.shape[0]
        sims = rows @ emb[i:].t()                       # (c, n - i)
        lead = torch.ones(c, c, dtype=torch.bool, device=dev).tril()
        sims[:, :c].masked_fill_(lead, float("-inf"))   # pairs j <= i
        for t in range(len(thr)):
            counts[t] += torch.count_nonzero(sims > thr[t])
        del sims           # before the next block is made, not after
    return counts.cpu().numpy(), n * (n - 1) // 2


def tpr_at_fpr(all_fpr: Sequence[float], all_fnr: Sequence[float],
               target: float) -> float:
    """1 - FNR at FPR ``target``, interpolated; thresholds ascend, so FPR
    descends and both curves are read reversed."""
    return 1.0 - float(np.interp(target, np.asarray(all_fpr)[::-1],
                                 np.asarray(all_fnr)[::-1]))


def evaluate_group(pos_emb, neg_emb, thresholds=None,
                   n_names_per_grp: int = 5, device: str = "cuda",
                   chunk: int = 2048) -> Dict:
    if thresholds is None:
        thresholds = np.linspace(0.3, 0.6, num=20)
    fnmr_c, n_pos = fnmr_counts(pos_emb, thresholds, n_names_per_grp,
                                device)
    fmr_c, n_neg = fmr_counts(neg_emb, thresholds, chunk, device)
    all_fnr = fnmr_c / n_pos
    all_fpr = fmr_c / n_neg
    return {"tpr_at_fpr_1e3": tpr_at_fpr(all_fpr, all_fnr, 1e-3),
            "tpr_at_fpr_1e4": tpr_at_fpr(all_fpr, all_fnr, 1e-4),
            "fnr_curve": all_fnr, "fpr_curve": all_fpr,
            "thresholds": thresholds}


def load_image(path: str) -> np.ndarray:
    """(112, 112, 3) float32 in [-1, 1]: RGB, PIL bilinear resize to 128,
    centre crop 112."""
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((128, 128), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr[8:120, 8:120] - 0.5) / 0.5


def embed_images(embed_fn: Callable, data_dir: str, names: Sequence[str],
                 batch_size: int = 256, workers: int = 8) -> np.ndarray:
    """``embed_fn`` over the named images in batches of ``batch_size`` (the
    tail padded with zeros), as float32 numpy; ``workers`` threads decode
    the images (PIL releases the GIL)."""
    out = []
    with ThreadPoolExecutor(workers) as pool:
        for i in range(0, len(names), batch_size):
            batch = list(pool.map(
                lambda n: load_image(os.path.join(data_dir, n)),
                names[i:i + batch_size]))
            n = len(batch)
            batch += [np.zeros_like(batch[0])] * (batch_size - n)
            emb = embed_fn(torch.from_numpy(np.stack(batch)))
            out.append(emb[:n].float().cpu().numpy())
    return np.concatenate(out, axis=0)


def evaluate_model(embed_fn: Callable, data_dir: str, partition_dir: str,
                   batch_size: int = 256,
                   groups: Sequence[str] = ETHNICITIES,
                   device: str = "cuda", chunk: int = 2048) -> Dict:
    """Every group's result. ``embed_fn``: (B, 112, 112, 3) [-1, 1] NHWC ->
    (B, D) L2-normalized embeddings (``eval.verify_runner.make_embed_fn(...,
    tta=False, ccrop=False)``); the partition lists ``pos_pairs_samples_
    <group>.txt`` and ``neg_pairs_samples_<group>.txt`` name the images
    under ``data_dir``. The counts run on ``device``."""
    results = {}
    for grp in groups:
        lists = {}
        for kind in ("pos", "neg"):
            with open(os.path.join(partition_dir,
                                   f"{kind}_pairs_samples_{grp}.txt")) as f:
                lists[kind] = f.read().splitlines()
        pos_emb = embed_images(embed_fn, data_dir, lists["pos"], batch_size)
        neg_emb = embed_images(embed_fn, data_dir, lists["neg"], batch_size)
        results[grp] = evaluate_group(pos_emb, neg_emb, device=device,
                                      chunk=chunk)
    return results
