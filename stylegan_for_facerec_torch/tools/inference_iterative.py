"""Iterative ReStyle inversion of a folder of images.

    python -m stylegan_for_facerec_torch.tools.inference_iterative \\
        --checkpoint_path ckpt.pt --data_path faces/ --exp_dir out/ \\
        [--device cuda|cpu]

Saves the last iteration's reconstruction of each image under
``exp_dir/inference_results`` and, with ``--save_latents``, every
iteration's latents in ``exp_dir/latents.npy``. With
``--model_2_checkpoint_path`` the run is encoder bootstrapping: the first
checkpoint's model makes the first inversion from its average image, the
second's runs the other iterations. Both load as ``PSp``, as in the JAX
package's CLI, so an e4e checkpoint's style heads give absolute codes
there, not deltas on w0. Either path may be a run directory: its newest
checkpoint loads (``utils.checkpoint.resolve_checkpoint_dir``), and an
``avg_image.npy`` in it or beside the checkpoint is the average image when
the checkpoint has none. Runs on the GPU unless
``--device cpu``; raises when no GPU is found.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint_path", required=True)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--exp_dir", required=True)
    ap.add_argument("--n_iters_per_batch", type=int, default=5)
    ap.add_argument("--test_batch_size", type=int, default=8)
    ap.add_argument("--output_size", type=int, default=128)
    ap.add_argument("--model_2_checkpoint_path", default=None,
                    help="encoder bootstrapping: the first checkpoint's "
                    "model initialises, this one iterates")
    ap.add_argument("--save_latents", action="store_true")
    ap.add_argument("--avg_image", default=None,
                    help="explicit avg-image .npy (overrides the "
                    "checkpoint's and an avg_image.npy beside it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from PIL import Image
    from ..data.images_dataset import InferenceDataset
    from ..eval.inference import encoder_bootstrap, tensor2im
    from ..models.psp import PSp
    from ..utils.checkpoint import load_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    model = PSp(output_size=args.output_size)
    avg_image = load_checkpoint(args.checkpoint_path, model)
    model = model.eval().to(device)
    if args.avg_image:
        avg_image = torch.from_numpy(np.load(args.avg_image))
        print(f"[init] avg image from {args.avg_image}")
    elif avg_image is None:
        for d in (args.checkpoint_path,
                  os.path.dirname(args.checkpoint_path.rstrip("/"))):
            p = os.path.join(d, "avg_image.npy")
            if os.path.exists(p):
                avg_image = torch.from_numpy(np.load(p))
                print(f"[init] avg image from {p}")
                break
    if avg_image is None:
        print("[warn] no avg image in or beside the checkpoint; "
              "conditioning on a ZERO average image — reconstructions "
              "will degrade (pass --avg_image)")
        avg_image = torch.zeros(112, 112, 3)
    avg_image = avg_image.to(device, torch.float32)
    model2 = model
    if args.model_2_checkpoint_path:
        model2 = PSp(output_size=args.output_size)
        load_checkpoint(args.model_2_checkpoint_path, model2)
        model2 = model2.eval().to(device)

    ds = InferenceDataset(args.data_path, size=112)
    out_dir = os.path.join(args.exp_dir, "inference_results")
    os.makedirs(out_dir, exist_ok=True)
    all_latents = {}
    bs = args.test_batch_size
    for i in range(0, len(ds), bs):
        idxs = list(range(i, min(i + bs, len(ds))))
        batch = torch.from_numpy(np.stack([ds[j] for j in idxs])).to(device)
        outs, lats = encoder_bootstrap(model, model2, batch, avg_image,
                                       args.n_iters_per_batch)
        for bi, j in enumerate(idxs):
            name = os.path.splitext(os.path.basename(ds.paths[j]))[0]
            Image.fromarray(tensor2im(outs[-1, bi])).save(
                os.path.join(out_dir, f"{name}.jpg"))
            if args.save_latents:
                all_latents[name] = lats[:, bi].float().cpu().numpy()
        print(f"[{min(i + bs, len(ds))}/{len(ds)}]")
    if args.save_latents:
        np.save(os.path.join(args.exp_dir, "latents.npy"), all_latents,
                allow_pickle=True)


if __name__ == "__main__":
    main()
