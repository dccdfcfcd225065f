"""RFW (and LFW-style) verification of a stage-3 checkpoint.

    python -m stylegan_for_facerec_torch.tools.test_rfw \\
        --checkpoint runs/s3/BUPT_IR_50_AfrAsian/step_000001000.pt \\
        --data_root rfw/ [--benchmarks rfw_African ...] [--no_tta] \\
        [--roc_dir rocs/] [--int8] [--device cuda|cpu]

The JAX package's ``tools/test_rfw.py``: builds the backbone (every name
``train_stage3.build_backbone`` takes, at 112 px; the JAX CLI builds
``pSp`` and the IR backbones), loads the checkpoint's backbone (a
``train_stage3`` checkpoint of this package, or its run directory: the
newest step, through ``utils.checkpoint.resolve_checkpoint_dir``), and
prints the 10-fold accuracy and best threshold of each
``data_root/<benchmark>.npz`` pair set; with ``--roc_dir`` each
benchmark's ROC curve is also written there as
``<benchmark>_ROC_Curve/0000.jpg`` (this needs matplotlib, which
nothing else of the package does). ``--int8`` also evaluates the
calibrated int8 path (``utils/quantize.py``): it calibrates on the first
benchmark's first 32 images, strips a copy of the backbone and prints
each benchmark's int8 accuracy and its change against f32 (returned as
``<benchmark>_int8``). Runs on the card unless ``--device cpu``; raises
when no GPU is found.
"""

from __future__ import annotations

import argparse
import os
import types


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="stage-3 checkpoint file of this package, or its "
                    "run directory (the newest step)")
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
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate the int8 serving path "
                    "(utils/quantize.py; calibrated on the first "
                    "benchmark's first 32 images) and print the accuracy "
                    "change against f32")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def calibrate_int8(backbone, carray, device):
    """The JAX CLI's calibration: the first 32 images of ``carray``,
    centre-cropped to 112 as the embed path sees them, in 4 batches of 8;
    returns (table, the stripped copy of ``backbone``)."""
    import numpy as np
    import torch

    from ..utils.quantize import (calibrate_and_quantize,
                                  strip_quantized_weights)

    imgs = np.asarray(carray[:32], np.float32)
    if imgs.shape[1] == 3:
        imgs = np.moveaxis(imgs, 1, -1)
    off = (imgs.shape[1] - 112) // 2
    if off > 0:
        imgs = imgs[:, off:off + 112, off:off + 112]
    x = torch.from_numpy(np.ascontiguousarray(imgs)).permute(0, 3, 1, 2)
    backbone.to(device)
    table = calibrate_and_quantize(
        backbone, [x[i:i + 8].to(device) for i in (0, 8, 16, 24)])
    return table, strip_quantized_weights(backbone, table)


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
    table = lean = None
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
            if args.int8:
                if table is None:
                    table, lean = calibrate_int8(backbone, carray, device)
                acc8, thr8, _ = perform_val(
                    lean, carray, issame, batch_size=args.batch_size,
                    emb_size=args.emb_size, tta=not args.no_tta,
                    device=str(device), int8_table=table)
                print(f"{bench}: int8 accuracy {acc8:.4f} "
                      f"(delta {acc8 - acc:+.4f}) best_threshold {thr8:.3f}")
                results[f"{bench}_int8"] = (acc8, thr8)
            if logger is not None:
                logger.log_benchmark(0, bench, acc, thr, roc=roc)
    finally:
        if logger is not None:
            logger.close()
    return results


if __name__ == "__main__":
    main()
