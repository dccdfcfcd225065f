"""Stage-2 ReStyle e4e encoder training.

    python -m stylegan_for_facerec_torch.tools.train_stage2_e4e \\
        --source_root faces/ --exp_dir runs/e4e \\
        --stylegan_weights ada.pt --lpips_weights lpips_alex.pt \\
        [--progressive_steps 0 20000 ...] [--device cuda|cpu] [--resume]

The flags of the JAX package's ``tools/train_stage2_e4e.py`` plus
``--device`` (the GPU unless ``--device cpu``; raises when no GPU is
found). ``--stylegan_weights`` and ``--lpips_weights`` are read as by
``train_stage2``: a stage-1 run directory or a torch StyleGAN2-ADA
checkpoint, and a ``torch.save``d ``LPIPS`` state_dict; with
``lpips_lambda > 0`` and no LPIPS weights the run is refused unless
``--allow_random_lpips``. Each step takes an encoder step and, with
``--w_discriminator_lambda`` > 0, a latent-discriminator step (R1 every
``--d_reg_every`` steps); ``--progressive_steps`` switches the encoder's
stage at those global steps. Validation (``--val_root``) includes the
adversarial term. Checkpoints go to ``exp_dir/step_*.pt`` (model,
``latent_avg``, ``avg_image``, the encoder's optimizer, D, D's optimizer,
step); they load as a ``PSp`` in ``inference_iterative``. SIGTERM/SIGINT
finish the step in flight, save, and return, and ``--resume`` continues
from the newest checkpoint with ``exp_dir/avg_image.npy``. The replay
pools and the random streams start anew on a resume.
"""

from __future__ import annotations

import argparse

import torch

from .train_stage2 import lpips_from_args, run


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--source_root", required=True)
    ap.add_argument("--target_root", default=None)
    ap.add_argument("--exp_dir", required=True)
    ap.add_argument("--output_size", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--n_iters_per_batch", type=int, default=1)
    ap.add_argument("--max_steps", type=int, default=2_500_000)
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--lpips_lambda", type=float, default=0.8)
    ap.add_argument("--l2_lambda", type=float, default=1.0)
    ap.add_argument("--w_discriminator_lambda", type=float, default=0.1)
    ap.add_argument("--delta_norm_lambda", type=float, default=2e-4)
    ap.add_argument("--progressive_steps", type=int, nargs="*", default=[])
    ap.add_argument("--d_reg_every", type=int, default=16)
    ap.add_argument("--stylegan_weights", default=None,
                    help="stage-1 run directory (its g_ema), or a torch "
                    "StyleGAN2-ADA checkpoint (G.* keys)")
    ap.add_argument("--lpips_weights", default=None,
                    help="torch.save'd LPIPS state_dict (net.*, lin.*)")
    ap.add_argument("--save_interval", type=int, default=1000)
    ap.add_argument("--image_interval", type=int, default=100)
    ap.add_argument("--image_display_count", type=int, default=2)
    ap.add_argument("--val_root", default=None)
    ap.add_argument("--val_interval", type=int, default=1000)
    ap.add_argument("--val_max_batches", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in exp_dir "
                    "(model, optimizers, discriminator, step; "
                    "avg_image.npy is reloaded)")
    ap.add_argument("--allow_random_lpips", action="store_true",
                    help="use RANDOM LPIPS features when no --lpips_weights "
                    "is given (debug only)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)

    from ..train.stage2_e4e import E4eCoach, E4eConfig
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = E4eConfig(output_size=args.output_size,
                    n_iters_per_batch=args.n_iters_per_batch,
                    l2_lambda=args.l2_lambda,
                    lpips_lambda=args.lpips_lambda,
                    learning_rate=args.learning_rate,
                    w_discriminator_lambda=args.w_discriminator_lambda,
                    delta_norm_lambda=args.delta_norm_lambda,
                    progressive_steps=tuple(args.progressive_steps),
                    d_reg_every=args.d_reg_every)
    coach = E4eCoach(cfg, lpips_fn=lpips_from_args(args, device),
                     device=str(device))
    noise = torch.Generator(device).manual_seed(3)
    real_z = torch.Generator(device).manual_seed(4)

    def train_step(step, x, y, avg_image):
        stage = coach.stage_for_step(step)
        if cfg.progressive_steps and stage != coach.model.stage:
            coach.set_stage(stage)
            print(f"[progressive] stage -> {stage}")
        loss, logs, y_hat = coach.train_step(x, y, avg_image, noise)
        if cfg.w_discriminator_lambda > 0:
            logs = dict(logs, d_loss=coach.train_discriminator(
                x, avg_image, step, real_z))
        return loss, logs, y_hat

    run(args, coach, device, train_step, noise)


if __name__ == "__main__":
    main()
