"""RB-WebFace TPR at FPR 1e-3 and 1e-4 of a stage-3 checkpoint.

    python -m stylegan_for_facerec_torch.tools.test_rb_webface \\
        --checkpoint runs/s3/BUPT_IR_50_AfrAsian/step_000001000.pt \\
        --data_path rb_webface/images --partition_path rb_webface/lists \\
        [--backbone pSp] [--emb_size 512] [--batch_size 256] \\
        [--groups African Asian ...] [--device cuda|cpu]

The JAX package's ``tools/test_rb_webface.py``: builds the backbone
(every name ``train_stage3.build_backbone`` takes, at 112 px), loads the
checkpoint's backbone (a ``train_stage3`` checkpoint of this package),
embeds each group's positive and negative lists without flip TTA
(``eval.rb_webface``: resize 128, centre crop 112) and prints each group's
TPR@FPR. Runs on the card unless ``--device cpu``; raises when no GPU is
found.
"""

from __future__ import annotations

import argparse
import types


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="stage-3 checkpoint file of this package")
    ap.add_argument("--data_path", required=True,
                    help="directory the partition lists' names are under")
    ap.add_argument("--partition_path", required=True,
                    help="directory of pos_pairs_samples_<group>.txt and "
                    "neg_pairs_samples_<group>.txt")
    ap.add_argument("--backbone", default="pSp")
    ap.add_argument("--emb_size", type=int, default=512)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--groups", nargs="+", default=None,
                    help="ethnic groups to evaluate (default: all four)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)

    from ..eval.rb_webface import ETHNICITIES, evaluate_model
    from ..eval.verify_runner import make_embed_fn
    from ..utils.checkpoint import load_backbone
    from ..utils.device import resolve_device
    from .train_stage3 import build_backbone

    device = str(resolve_device(args.device))
    backbone = build_backbone(types.SimpleNamespace(
        backbone=args.backbone, input_size=(112, 112),
        emb_size=args.emb_size, dropout=None))
    load_backbone(args.checkpoint, backbone)
    embed_fn = make_embed_fn(backbone, tta=False, ccrop=False, device=device)
    results = evaluate_model(embed_fn, args.data_path, args.partition_path,
                             batch_size=args.batch_size,
                             groups=tuple(args.groups or ETHNICITIES),
                             device=device)
    for grp, res in results.items():
        print("=" * 20)
        print("Group", grp)
        print("TPR@FPR=1e-3", res["tpr_at_fpr_1e3"])
        print("TPR@FPR=1e-4", res["tpr_at_fpr_1e4"])
    return results


if __name__ == "__main__":
    main()
