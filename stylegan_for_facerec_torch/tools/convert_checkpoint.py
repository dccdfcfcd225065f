"""Checkpoint conversion between the reference torch layout and the JAX
package's checkpoint directories, without JAX: the JAX package's
``tools/convert_checkpoint.py``.

    python -m stylegan_for_facerec_torch.tools.convert_checkpoint to_jax \\
        --model ir_se50 --src backbone.pth --dst ckpt/ [--key_prefix P] \\
        [--output_size 128] [--strict]
    python -m stylegan_for_facerec_torch.tools.convert_checkpoint to_torch \\
        --model psp --src ckpt/ --dst psp.pt [--output_size 256]
    python -m stylegan_for_facerec_torch.tools.convert_checkpoint to_jax \\
        --model lpips --src lin_alex.pth --alexnet alexnet.pth --dst lpips/

Models: ``ir50``, ``ir_se50``, ``psp_facerec`` (at 112), ``psp`` and
``ada_generator`` (at ``--output_size``), and ``lpips`` (to_jax only:
the richzhang lin weights plus a torchvision AlexNet state_dict, the tree
``train_stage2 --lpips_weights`` loads).

* ``to_jax``: a torch ``.pt``/``.pth`` state_dict (bare or under
  ``state_dict``; ``--key_prefix`` slices e.g. ``encoder`` out of a pSp
  bundle or ``G`` out of an ADA dump) -> the port's model ->
  ``utils.convert.to_jax`` -> ``{"params", "state"}`` written as a JAX npz
  checkpoint directory (``utils.checkpoint.write_jax_checkpoint``); the
  JAX package's ``load_checkpoint`` reads it with ``like=``. Without
  ``--strict`` a missing tensor leaves its leaf out.
* ``to_torch``: a JAX checkpoint directory (``read_jax_checkpoint``) ->
  ``utils.convert.from_jax`` -> the reference-named state_dict saved with
  ``torch.save``. The out-of-band ``avg_image`` of ``psp_facerec`` and
  ``latent_avg`` of ``psp`` are not in it, as in the JAX tool's output.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def build_model(kind: str, output_size: int = 128):
    from ..losses.perceptual import LPIPS
    from ..models import irse
    from ..models.psp import PSp, PSpFaceRec
    from ..models.stylegan2_ada import Generator

    if kind == "ir50":
        return irse.IR_50(112)
    if kind == "ir_se50":
        return irse.IR_SE_50(112)
    if kind == "psp_facerec":
        return PSpFaceRec(size=112)
    if kind == "psp":
        return PSp(output_size=output_size)
    if kind == "ada_generator":
        return Generator(img_resolution=output_size)
    if kind == "lpips":
        return LPIPS("alex")
    raise SystemExit(f"unknown model kind {kind!r}")


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def lpips_state_dict(src: str, alexnet: str) -> dict:
    """The port LPIPS's state_dict from the richzhang lin weights (keys
    ``lin{i}.model.1.weight``) and a torchvision AlexNet state_dict (its
    ``features.*``), with the renames of the JAX tool."""
    lin = {k.replace("lin", "").replace("model.", ""): v
           for k, v in _load(src).items()}
    alex = _load(alexnet)
    alex = alex.get("state_dict", alex)
    feats = {k[len("features."):]: v for k, v in alex.items()
             if k.startswith("features.")} or alex
    sd = {f"net.{k}": v for k, v in feats.items()}
    sd.update({f"lin.{i}.weight": lin[f"{i}.1.weight"] for i in range(5)})
    return sd


def convert_to_jax(kind: str, src: str, dst: str, output_size: int = 128,
                   key_prefix: str = "", strict: bool = False,
                   alexnet: str = None) -> int:
    from ..utils.checkpoint import write_jax_checkpoint
    from ..utils.convert import to_jax

    model = build_model(kind, output_size)
    if kind == "lpips":
        if not alexnet:
            raise SystemExit("lpips conversion: use to_jax with --src "
                             "<richzhang lin .pth> --alexnet <torchvision "
                             "alexnet .pth>")
        params, _ = to_jax(model, lpips_state_dict(src, alexnet))
        write_jax_checkpoint(dst, params, metadata={"source": src})
        return len(params)
    ckpt = _load(src)
    sd = ckpt.get("state_dict", ckpt)
    if key_prefix:
        p = key_prefix + "."
        sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
    params, state = to_jax(model, sd, strict=strict)
    write_jax_checkpoint(dst, {"params": params, "state": state},
                         metadata={"source": src, "model": kind})
    return len(sd)


def convert_lpips(src: str, alexnet: str, dst: str) -> None:
    """The JAX tool's LPIPS conversion: the richzhang lin weights and a
    torchvision AlexNet state_dict as the checkpoint directory
    ``train_stage2 --lpips_weights`` loads (``to_jax --model lpips``)."""
    convert_to_jax("lpips", src, dst, alexnet=alexnet)
    print(f"converted LPIPS weights -> {dst}")


def convert_to_torch(kind: str, src: str, dst: str,
                     output_size: int = 128) -> int:
    from ..models.psp import PSpFaceRec
    from ..utils.checkpoint import read_jax_checkpoint
    from ..utils.convert import from_jax

    if kind == "lpips":
        raise SystemExit("lpips converts to_jax only, as in the JAX tool")
    model = build_model(kind, output_size)
    tree = read_jax_checkpoint(src)
    state = dict(tree.get("state", {}))
    if isinstance(model, PSpFaceRec):
        # out of band in reference checkpoints: not written
        state.setdefault("avg_image", np.zeros((112, 112, 3), np.float32))
    sd = from_jax(model, tree["params"], state)
    if isinstance(model, PSpFaceRec):
        del sd["avg_image"]
    torch.save(sd, dst)
    return len(sd)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("direction", choices=["to_jax", "to_torch"])
    ap.add_argument("--model", required=True,
                    help="ir50|ir_se50|psp_facerec|psp|ada_generator|lpips")
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--output_size", type=int, default=128)
    ap.add_argument("--key_prefix", default="",
                    help="e.g. 'encoder' to slice a pSp bundle, 'G' for "
                         "ADA-lightning generator dumps")
    ap.add_argument("--alexnet", default=None,
                    help="torchvision alexnet state_dict .pth (lpips only)")
    ap.add_argument("--strict", action="store_true")
    args = ap.parse_args(argv)
    if args.direction == "to_jax":
        n = convert_to_jax(args.model, args.src, args.dst, args.output_size,
                           args.key_prefix, args.strict, args.alexnet)
        print(f"converted {n} torch tensors -> {args.dst}")
    else:
        n = convert_to_torch(args.model, args.src, args.dst,
                             args.output_size)
        print(f"exported {n} tensors -> {args.dst}")


if __name__ == "__main__":
    main()
