"""Iterative ReStyle inversion (``run_on_batch``), encoder bootstrapping
(``encoder_bootstrap``), feature extraction (``extract_features_from_folder``,
``extract_feature_single``), ``tensor2im`` and ``face_grid``.

Public layout is NHWC, as in the JAX package: images in and out are
(B, H, W, 3) in [-1, 1]."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..models.psp import PSp
from ..ops.image import hflip, resize_bilinear
from ..utils.device import resolve_device
from ..utils.quantize import hooked
from ..utils.tracing import span


def run_on_batch(model: PSp, inputs: torch.Tensor, avg_image: torch.Tensor,
                 n_iters: int, resize_outputs: bool = True, quant=None):
    """inputs: (B, H, W, 3) on the model's device; avg_image: (H, W, 3).
    Runs ``n_iters`` refinement iterations with const noise and returns
    (outputs per iteration (iters, B, H', W', 3), latents per iteration
    (iters, B, n_styles, 512)).

    ``quant``: a hook of ``utils.quantize`` installed over the whole loop,
    so the encoder's convs and linears and the decoder's modulated convs
    of every iteration go to it, one entry a call: a fresh
    ``Int8Apply(table.entries)`` serves the int8 loop, a recorder
    (``calibrate_with``) calibrates it."""
    with contextlib.nullcontext() if quant is None else hooked(quant):
        return encoder_bootstrap(model, model, inputs, avg_image, n_iters,
                                 resize_outputs)


@torch.inference_mode()
def encoder_bootstrap(model1: PSp, model2: PSp, inputs: torch.Tensor,
                      avg_image1: torch.Tensor, n_iters: int,
                      resize_outputs: bool = True):
    """Encoder bootstrapping: ``model1`` makes the first inversion from its
    average image ``avg_image1`` (its ``latent_avg`` as the start), and
    ``model2`` runs the other ``n_iters - 1`` iterations from that output
    and latent. Shapes as ``run_on_batch``'s; both models in eval mode.
    Spans (``utils/tracing.py``): ``sgfr.invert.call`` around each
    iteration's ``sgfr.invert.iteration``, which holds the model's spans
    and ``sgfr.invert.resize`` (the next conditioning)."""
    if model1.training or model2.training:
        raise ValueError("iterative inversion needs its models in eval "
                         "mode (BatchNorm running statistics)")
    with span("sgfr.invert.call"):
        x = inputs.permute(0, 3, 1, 2)
        h, w = x.shape[-2:]
        cond = avg_image1.permute(2, 0, 1)[None].to(x.dtype).expand_as(x)
        latent = None
        outs, lats = [], []
        for it in range(n_iters):
            model = model1 if it == 0 else model2
            with span("sgfr.invert.iteration"):
                y_hat, latent = model(torch.cat([x, cond], dim=1), latent,
                                      resize=resize_outputs,
                                      randomize_noise=False,
                                      return_latents=True)
                outs.append(y_hat.permute(0, 2, 3, 1))
                lats.append(latent)
                # resize back to the input size for the next conditioning
                with span("sgfr.invert.resize"):
                    cond = resize_bilinear(y_hat, h, w)
        return torch.stack(outs), torch.stack(lats)


def extract_features_from_folder(backbone: torch.nn.Module, root: str,
                                 input_size: int = 112,
                                 emb_size: int = 512, batch_size: int = 256,
                                 tta: bool = True,
                                 device: str = "cuda") -> np.ndarray:
    """(N, emb_size) L2-normalized embeddings of the images of a
    ``<root>/<identity>/<file>`` tree in ``FacesDataset`` order: each
    resized to 128 * input_size / 112, centre-cropped to 112 without the
    uint8 round trip, the image and its mirror embedded and summed. A
    corrupt file embeds a zero image."""
    from ..data.dataset import FacesDataset
    from .verify_runner import compute_embeddings, make_embed_fn

    ds = FacesDataset(root, image_size=int(128 * input_size / 112))
    s = ds.image_size
    imgs = []
    for i in range(len(ds)):
        item = ds.load(i)
        imgs.append(np.zeros((s, s, 3), np.float32) if item is None
                    else item[0])
    arr = np.stack(imgs) if imgs else np.zeros((0, s, s, 3), np.float32)
    embed = make_embed_fn(backbone, tta=tta, ccrop=True, device=device,
                          quantize=False)
    return compute_embeddings(embed, arr, batch_size, emb_size)


@torch.no_grad()
def extract_feature_single(backbone: torch.nn.Module, img_path: str,
                           tta: bool = True,
                           device: str = "cuda") -> np.ndarray:
    """(1, emb) L2-normalized embedding of one image file: read with cv2
    (BGR), resized to 128, centre-cropped to 112, to RGB, (x - 127.5) /
    128, the image and its mirror embedded and summed. cv2 is imported
    here, only when called."""
    import cv2

    dev = resolve_device(device)
    img = cv2.imread(img_path)
    if img is None:
        raise FileNotFoundError(f"cv2 cannot read {img_path}")
    cc = cv2.resize(img, (128, 128))[8:120, 8:120][..., ::-1]
    x = torch.from_numpy((np.asarray(cc, np.float32) - 127.5) / 128.0)
    x = x[None].to(dev)
    backbone.to(dev)
    was_training = backbone.training
    backbone.eval()
    try:
        e = backbone(x.permute(0, 3, 1, 2)).float()
        if tta:
            e = e + backbone(hflip(x).permute(0, 3, 1, 2)).float()
    finally:
        backbone.train(was_training)
    return (e / torch.linalg.norm(e, dim=1, keepdim=True)).cpu().numpy()


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
