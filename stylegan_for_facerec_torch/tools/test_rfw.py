"""RFW (and LFW-style) verification of a stage-3 checkpoint.

    python -m stylegan_for_facerec_torch.tools.test_rfw \\
        --checkpoint runs/s3/BUPT_IR_50_AfrAsian/step_000001000.pt \\
        --data_root rfw/ [--benchmarks rfw_African ...] [--no_tta] \\
        [--device cuda|cpu]

The JAX package's ``tools/test_rfw.py``: builds the backbone (``pSp`` or
an IR ``Backbone`` by name, at 112 px), loads the checkpoint's backbone
(a ``train_stage3`` checkpoint of this package), and prints the 10-fold
accuracy and best threshold of each ``data_root/<benchmark>.npz`` pair
set. Runs on the card unless ``--device cpu``; raises when no GPU is
found.
"""

from __future__ import annotations

import argparse
import os


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="stage-3 checkpoint file of this package")
    ap.add_argument("--data_root", required=True,
                    help="directory of packed <benchmark>.npz pair sets")
    ap.add_argument("--benchmarks", nargs="+",
                    default=["rfw_African", "rfw_Asian", "rfw_Caucasian",
                             "rfw_Indian"])
    ap.add_argument("--backbone", default="pSp")
    ap.add_argument("--emb_size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--no_tta", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)

    from ..eval.verify_runner import load_val_pair, perform_val
    from ..models import irse, psp
    from ..utils.checkpoint import load_backbone
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    if args.backbone == "pSp":
        backbone = psp.PSpFaceRec(size=112, emb_size=args.emb_size)
    elif args.backbone.startswith("IR_") and hasattr(irse, args.backbone):
        backbone = getattr(irse, args.backbone)(112, emb_size=args.emb_size)
    else:
        raise SystemExit(f"unknown backbone {args.backbone}")
    load_backbone(args.checkpoint, backbone)
    results = {}
    for bench in args.benchmarks:
        carray, issame = load_val_pair(os.path.join(args.data_root, bench))
        acc, thr, _ = perform_val(backbone, carray, issame,
                                  batch_size=args.batch_size,
                                  emb_size=args.emb_size,
                                  tta=not args.no_tta, device=str(device))
        print(f"{bench}: accuracy {acc:.4f} best_threshold {thr:.3f}")
        results[bench] = (acc, thr)
    return results


if __name__ == "__main__":
    main()
