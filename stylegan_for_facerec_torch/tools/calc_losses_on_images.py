"""Reconstruction losses between a folder of results and its ground truth.

    python -m stylegan_for_facerec_torch.tools.calc_losses_on_images \\
        --data_path results/ --gt_path gt/ [--mode l2 lpips id] \\
        [--size 112] [--batch_size 64] [--lpips_weights lpips.pt] \\
        [--id_checkpoint ir_se50.pt] [--device cuda|cpu]

The flags of the JAX package's ``tools/calc_losses_on_images.py`` plus
``--device`` (the GPU unless ``--device cpu``; raises when no GPU is
found). Pairs come from ``data.images_dataset.GTResDataset`` (same file
name in both folders, resized to ``--size``). Per pair: ``l2``, the mean
squared difference; ``lpips``, LPIPS-alex of the pair alone; ``id``, 1 -
the cosine of the two IR-SE-50 ID embeddings (``losses.identity``'s face
crop, pooled to 112). LPIPS weights are a state_dict file of
``losses.perceptual.LPIPS("alex")`` (as ``train_stage2 --lpips_weights``
takes), the ID weights a state_dict file of ``models.irse.Backbone(112,
50, "ir_se")``; without them the weights are seeded random, with a
warning. Prints {mode: {"mean", "std"}} as JSON and writes it to
``<data_path>/stat_losses.json``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_path", required=True, help="result images")
    ap.add_argument("--gt_path", required=True)
    ap.add_argument("--mode", nargs="+", default=["l2", "lpips"],
                    choices=["l2", "lpips", "id"])
    ap.add_argument("--size", type=int, default=112)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--lpips_weights", default=None)
    ap.add_argument("--id_checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def loss_fns(args, device):
    """{mode: fn(a, b) -> (B,) per-pair losses} for NHWC [-1, 1] batches
    on ``device``."""
    from ..losses.identity import make_irse_id_extractor
    from ..losses.perceptual import LPIPS
    from ..models.irse import Backbone
    from ..nn.initializers import init_weights
    from ..utils.checkpoint import load_state_dict_file

    fns = {}
    if "l2" in args.mode:
        fns["l2"] = lambda a, b: (a - b).square().mean(dim=(1, 2, 3))
    if "lpips" in args.mode:
        lp = LPIPS("alex")
        if args.lpips_weights:
            load_state_dict_file(args.lpips_weights, lp)
        else:
            print("[warn] random-init LPIPS (no --lpips_weights)")
            init_weights(lp, torch.Generator().manual_seed(0))
        lp = lp.to(device).eval()
        fns["lpips"] = lp.per_sample
    if "id" in args.mode:
        net = Backbone(input_size=112, num_layers=50, mode="ir_se",
                       drop_ratio=0.6)
        if args.id_checkpoint:
            load_state_dict_file(args.id_checkpoint, net)
        else:
            print("[warn] random-init ID backbone (no --id_checkpoint)")
            init_weights(net, torch.Generator().manual_seed(1))
        extract = make_irse_id_extractor(net.to(device))
        fns["id"] = lambda a, b: 1.0 - (extract(a) * extract(b)).sum(dim=1)
    return fns


@torch.no_grad()
def main(argv=None) -> dict:
    args = _parse(argv)

    from ..data.images_dataset import GTResDataset
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    ds = GTResDataset(args.data_path, args.gt_path, size=args.size)
    print(f"{len(ds)} pairs")
    fns = loss_fns(args, device)
    scores = {m: [] for m in fns}
    for i in range(0, len(ds), args.batch_size):
        batch = [ds[j] for j in range(i, min(i + args.batch_size, len(ds)))]
        a = torch.from_numpy(np.stack([p[0] for p in batch])).to(device)
        b = torch.from_numpy(np.stack([p[1] for p in batch])).to(device)
        for m, fn in fns.items():
            scores[m].extend(fn(a, b).float().cpu().tolist())
    out = {m: {"mean": float(np.mean(v)), "std": float(np.std(v))}
           for m, v in scores.items() if v}
    print(json.dumps(out, indent=2))
    with open(os.path.join(args.data_path, "stat_losses.json"), "w") as f:
        json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
