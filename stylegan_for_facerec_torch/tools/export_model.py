"""Export a trained model as a standalone ``torch.export`` serving
artifact (``artifact.pt2`` + ``export.json``), the JAX package's
``tools/export_model.py`` with ``--device`` in place of ``--platforms``:

    python -m stylegan_for_facerec_torch.tools.export_model \\
        --kind embedder --checkpoint <run dir or stage-3 .pt> --out exp/ \\
        [--backbone pSp|MobileFaceNet|IR_SE_50|ResNet_50|...] [--batch B] \\
        [--dtype float32|bfloat16] [--device cuda|cpu]
    python -m stylegan_for_facerec_torch.tools.export_model \\
        --kind generator --checkpoint <stage-1 run dir or ADA .pt> \\
        --out exp/ [--img_resolution 256] [--z_dim 512]

Kinds:
  embedder   face-rec backbone (a name ``train_stage3.build_backbone``
             takes), images (b, H, W, 3) -> embeddings (b, E), not
             L2-normalized; the checkpoint is a JAX package run
             directory (read without JAX), or a stage-3 checkpoint file
             or run directory (its newest step) of this package
  generator  StyleGAN2-ADA synthesis, z -> images (b, H, W, 3) with const
             noise, from a stage-1 run directory of this package or a torch
             ADA checkpoint (``G.*`` keys)

Load and run an artifact with ``utils.export.load_exported(out).module()``
on the device it was exported on (the card unless ``--device cpu``).
"""

from __future__ import annotations

import argparse
import os
import types


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["embedder", "generator"],
                    default="embedder")
    ap.add_argument("--checkpoint", required=True,
                    help="embedder: a JAX package run/checkpoint dir, or a "
                    "stage-3 .pt or run dir of this package; generator: a "
                    "stage-1 run dir of this package or a torch ADA .pt")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--device", default="cuda",
                    help="the device the artifact is exported for")
    ap.add_argument("--batch", type=int, default=None,
                    help="pin the batch dim (default: symbolic)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--backbone", default="pSp")
    ap.add_argument("--emb_size", type=int, default=512)
    ap.add_argument("--image_size", type=int, default=112)
    ap.add_argument("--img_resolution", type=int, default=256)
    ap.add_argument("--z_dim", type=int, default=512)
    return ap.parse_args(argv)


def load_embedder(model, path: str) -> str:
    """Fill ``model`` from a JAX package checkpoint directory (its
    ``backbone`` subtree when it has one) or a stage-3 file of this
    package; returns the source's name."""
    from ..utils.checkpoint import (load_backbone, read_jax_checkpoint,
                                    resolve_checkpoint_dir)
    from ..utils.convert import load_from_jax

    if os.path.isdir(resolve_checkpoint_dir(path)):
        tree = read_jax_checkpoint(path)
        params, state = tree["params"], tree.get("state", {})
        load_from_jax(model, params.get("backbone", params),
                      state.get("backbone", state))
        return "JAX package checkpoint"
    load_backbone(path, model)
    return "stage-3 checkpoint"


def main(argv=None):
    import torch

    from ..utils import export as exu
    from ..utils.device import resolve_device

    args = _parse(argv)
    dtype = getattr(torch, args.dtype)
    device = str(resolve_device(args.device))
    if args.kind == "embedder":
        from .train_stage3 import build_backbone

        model = build_backbone(types.SimpleNamespace(
            backbone=args.backbone, input_size=(args.image_size,) * 2,
            emb_size=args.emb_size, dropout=None))
        src = load_embedder(model, args.checkpoint)
        exported = exu.export_embedder(
            model, image_size=args.image_size, dtype=dtype,
            batch=args.batch, device=device)
        meta = {"kind": "embedder", "backbone": args.backbone}
    else:
        from ..models.stylegan2_ada import Generator
        from ..utils.checkpoint import load_generator_handoff

        model = Generator(z_dim=args.z_dim,
                          img_resolution=args.img_resolution)
        src = load_generator_handoff(args.checkpoint, model)
        exported = exu.export_generator(model, z_dim=args.z_dim, dtype=dtype,
                                        batch=args.batch, device=device)
        meta = {"kind": "generator"}
    meta.update(source=src, checkpoint=os.path.abspath(args.checkpoint),
                dtype=args.dtype)
    exu.save_exported(exported, args.out, metadata=meta, fn_name=args.kind)
    size = os.path.getsize(os.path.join(args.out, exu.ARTIFACT))
    print(f"exported {args.kind} -> {args.out} ({size / 1e6:.1f} MB, "
          f"device={device})")
    return exported


if __name__ == "__main__":
    main()
