"""Iterative ReStyle inversion (``run_on_batch``), encoder bootstrapping
(``encoder_bootstrap``), ``tensor2im`` and ``face_grid``.

Public layout is NHWC, as in the JAX package: images in and out are
(B, H, W, 3) in [-1, 1]."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models.psp import PSp
from ..ops.image import resize_bilinear


def run_on_batch(model: PSp, inputs: torch.Tensor, avg_image: torch.Tensor,
                 n_iters: int, resize_outputs: bool = True):
    """inputs: (B, H, W, 3) on the model's device; avg_image: (H, W, 3).
    Runs ``n_iters`` refinement iterations with const noise and returns
    (outputs per iteration (iters, B, H', W', 3), latents per iteration
    (iters, B, n_styles, 512))."""
    return encoder_bootstrap(model, model, inputs, avg_image, n_iters,
                             resize_outputs)


@torch.inference_mode()
def encoder_bootstrap(model1: PSp, model2: PSp, inputs: torch.Tensor,
                      avg_image1: torch.Tensor, n_iters: int,
                      resize_outputs: bool = True):
    """Encoder bootstrapping: ``model1`` makes the first inversion from its
    average image ``avg_image1`` (its ``latent_avg`` as the start), and
    ``model2`` runs the other ``n_iters - 1`` iterations from that output
    and latent. Shapes as ``run_on_batch``'s; both models in eval mode."""
    if model1.training or model2.training:
        raise ValueError("iterative inversion needs its models in eval "
                         "mode (BatchNorm running statistics)")
    x = inputs.permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    cond = avg_image1.permute(2, 0, 1)[None].to(x.dtype).expand_as(x)
    latent = None
    outs, lats = [], []
    for it in range(n_iters):
        model = model1 if it == 0 else model2
        y_hat, latent = model(torch.cat([x, cond], dim=1), latent,
                              resize=resize_outputs, randomize_noise=False,
                              return_latents=True)
        outs.append(y_hat.permute(0, 2, 3, 1))
        lats.append(latent)
        # resize back to the input size for the next conditioning
        cond = resize_bilinear(y_hat, h, w)
    return torch.stack(outs), torch.stack(lats)


def tensor2im(x) -> np.ndarray:
    """(H, W, 3) in [-1, 1] -> uint8 image."""
    arr = x.detach().float().cpu().numpy() if torch.is_tensor(x) \
        else np.asarray(x)
    arr = np.clip((arr + 1) / 2, 0, 1) * 255
    return arr.astype(np.uint8)


def face_grid(entries: List[Dict]) -> np.ndarray:
    """Tile rows of [input | target | outputs...] faces ((H, W, 3) in
    [-1, 1]; ``output_face`` one image or a list) into one uint8 image."""
    rows = []
    for e in entries:
        imgs = [tensor2im(e["input_face"]), tensor2im(e["target_face"])]
        outs = e["output_face"]
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        imgs += [tensor2im(o) for o in outs]
        h = max(im.shape[0] for im in imgs)
        imgs = [np.pad(im, ((0, h - im.shape[0]), (0, 0), (0, 0)))
                for im in imgs]
        rows.append(np.concatenate(imgs, axis=1))
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows]
    return np.concatenate(rows, axis=0)
