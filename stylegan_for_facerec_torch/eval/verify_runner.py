"""Verification runner, as ``stylegan_for_facerec_tpu/eval/verify_runner.py``:
the TTA embedding (centre-crop TTA, the image and its mirror embedded and
summed, then L2-normalized) on the card, in f32, bf16 or calibrated int8, and the 10-fold threshold sweep
of ``eval.verification`` on the host.

Images are NHWC in [-1, 1]. The backbone runs in eval mode under
``torch.no_grad`` on ``device`` (the GPU unless the caller asks for the
CPU) and is left in the mode it was in.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.image import ccrop_tta, hflip
from ..utils.device import resolve_device
from ..utils.quantize import quantized_apply
from .verification import evaluate


def make_embed_fn(backbone: nn.Module, tta: bool = True, ccrop: bool = True,
                  device: str = "cuda", compute_dtype: str = "float32",
                  quantize: bool = True, int8_table=None) -> Callable:
    """(B, H, W, 3) [-1, 1] tensor -> (B, emb) float32 embeddings on
    ``device``: emb = backbone(ccrop(x)) [+ backbone(hflip(ccrop(x)))],
    then L2-normalized. ``quantize`` puts the centre crop's input and
    output through the uint8 round trip (the reference's PIL path);
    ``compute_dtype="bfloat16"`` runs the backbone under autocast.
    ``int8_table`` (a ``utils.quantize.Int8Table``) runs the backbone's
    convs and linears on the calibrated int8 path instead, in f32 around
    them (``_embed_jit_int8`` of the JAX package); pass
    ``strip_quantized_weights(backbone, table)`` as ``backbone`` to drop
    its f32 weights. Moves ``backbone`` (and the table) to ``device``."""
    dev = resolve_device(device)
    backbone.to(dev)
    bf16 = compute_dtype == "bfloat16"
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: float32|bfloat16")
    if int8_table is not None and bf16:
        raise ValueError("int8_table runs its rescales in f32: "
                         "compute_dtype must be float32")
    table = None if int8_table is None else int8_table.to(dev)

    def run(x):
        if table is None:
            return backbone(x)
        return quantized_apply(backbone, x, table)

    @torch.no_grad()
    def fn(images: torch.Tensor) -> torch.Tensor:
        was_training = backbone.training
        backbone.eval()
        try:
            x = images.to(dev, torch.float32, non_blocking=True)
            if ccrop:
                x = ccrop_tta(x, quantize=quantize)
            with torch.autocast(dev.type, dtype=torch.bfloat16,
                                enabled=bf16):
                e = run(x.permute(0, 3, 1, 2)).float()
                if tta:
                    e = e + run(hflip(x).permute(0, 3, 1, 2)).float()
        finally:
            backbone.train(was_training)
        return e / torch.linalg.norm(e, dim=1, keepdim=True)

    return fn


def compute_embeddings(embed_fn: Callable, carray, batch_size: int = 256,
                       emb_size: int = 512) -> np.ndarray:
    """Batch the (N, H, W, 3) or (N, 3, H, W) float array through
    ``embed_fn``; the ragged tail is padded with zeros to one batch shape,
    so every call sees the same shape."""
    arr = np.asarray(carray)
    if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
        arr = np.moveaxis(arr, 1, -1)
    n = arr.shape[0]
    out = np.zeros((n, emb_size), np.float32)
    for i in range(0, n, batch_size):
        chunk = np.ascontiguousarray(arr[i: i + batch_size], np.float32)
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
        emb = embed_fn(torch.from_numpy(chunk)).cpu().numpy()
        out[i: i + batch_size] = emb[: batch_size - pad]
    return out


def perform_val(backbone: nn.Module, carray, issame, batch_size: int = 256,
                emb_size: int = 512, nrof_folds: int = 10, tta: bool = True,
                ccrop: bool = True, device: str = "cuda",
                compute_dtype: str = "float32", int8_table=None
                ) -> Tuple[float, float, Tuple[np.ndarray, np.ndarray]]:
    """(mean accuracy, mean best threshold, (tpr, fpr)) over
    ``nrof_folds`` folds of the pairs (rows 2i, 2i + 1 of ``carray``);
    ``int8_table`` runs the int8 path (``make_embed_fn``)."""
    embed_fn = make_embed_fn(backbone, tta=tta, ccrop=ccrop, device=device,
                             compute_dtype=compute_dtype,
                             int8_table=int8_table)
    embeddings = compute_embeddings(embed_fn, carray, batch_size, emb_size)
    tpr, fpr, accuracy, best = evaluate(embeddings, issame, nrof_folds)
    return float(accuracy.mean()), float(best.mean()), (tpr, fpr)


def load_val_pair(path: str):
    """``<path>.npz`` with 'images' (N, H, W, 3 float32 in [-1, 1]) and
    'issame' (N/2 bools): the packed verification format."""
    if not os.path.exists(path + ".npz"):
        raise FileNotFoundError(f"no {path}.npz")
    d = np.load(path + ".npz")
    return d["images"], d["issame"]


RFW_ETHNICITIES = ("African", "Asian", "Caucasian", "Indian")


def get_rfw_val_data(data_root: str, ethnicities=RFW_ETHNICITIES):
    """{ethnicity: (images, issame)} from ``data_root/rfw_<ethnicity>.npz``."""
    return {eth: load_val_pair(os.path.join(data_root, f"rfw_{eth}"))
            for eth in ethnicities}
