"""RFW (and LFW-style) verification of a stage-3 checkpoint.

    python -m stylegan_for_facerec_torch.tools.test_rfw \\
        --checkpoint runs/s3/BUPT_IR_50_AfrAsian/step_000001000.pt \\
        --data_root rfw/ [--benchmarks rfw_African ...] [--no_tta] \\
        [--roc_dir rocs/] [--device cuda|cpu]

The JAX package's ``tools/test_rfw.py``: builds the backbone (every name
``train_stage3.build_backbone`` takes, at 112 px; the JAX CLI builds
``pSp`` and the IR backbones), loads the checkpoint's backbone
(a ``train_stage3`` checkpoint of this package), and prints the 10-fold
accuracy and best threshold of each ``data_root/<benchmark>.npz`` pair
set; with ``--roc_dir`` each benchmark's ROC curve is also written there
as ``<benchmark>_ROC_Curve/0000.png`` (this needs matplotlib, which
nothing else of the package does). Runs on the card unless ``--device
cpu``; raises when no GPU is found.
"""

from __future__ import annotations

import argparse
import os
import types


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
    ap.add_argument("--roc_dir", default=None,
                    help="write each benchmark's ROC curve image here")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)

    from ..eval.verify_runner import load_val_pair, perform_val
    from ..utils.checkpoint import load_backbone
    from ..utils.device import resolve_device
    from .train_stage3 import build_backbone

    device = resolve_device(args.device)
    backbone = build_backbone(types.SimpleNamespace(
        backbone=args.backbone, input_size=(112, 112),
        emb_size=args.emb_size, dropout=None))
    load_backbone(args.checkpoint, backbone)
    logger = None
    if args.roc_dir:
        from ..utils.logging import MetricLogger
        logger = MetricLogger(args.roc_dir)
    results = {}
    try:
        for bench in args.benchmarks:
            carray, issame = load_val_pair(os.path.join(args.data_root,
                                                        bench))
            acc, thr, roc = perform_val(backbone, carray, issame,
                                        batch_size=args.batch_size,
                                        emb_size=args.emb_size,
                                        tta=not args.no_tta,
                                        device=str(device))
            print(f"{bench}: accuracy {acc:.4f} best_threshold {thr:.3f}")
            results[bench] = (acc, thr)
            if logger is not None:
                logger.log_benchmark(0, bench, acc, thr, roc=roc)
    finally:
        if logger is not None:
            logger.close()
    return results


if __name__ == "__main__":
    main()
