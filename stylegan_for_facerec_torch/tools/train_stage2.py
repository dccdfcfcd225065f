"""Stage-2 ReStyle pSp encoder training.

    python -m stylegan_for_facerec_torch.tools.train_stage2 \\
        --source_root faces/ --exp_dir runs/s2 \\
        --stylegan_weights ada.pt --lpips_weights lpips_alex.pt \\
        [--device cuda|cpu] [--resume]

The flags of the JAX package's ``tools/train_stage2.py`` plus ``--device``
(the GPU unless ``--device cpu``; raises when no GPU is found).
``--stylegan_weights`` is a stage-1 run directory of
``tools/train_stage1.py``, whose newest checkpoint's ``g_ema`` loads into
the generator (the stage-1 -> stage-2 handoff), or a torch StyleGAN2-ADA
checkpoint whose ``G.*`` keys load; ``--lpips_weights`` a
``torch.save``d ``LPIPS`` state_dict. With ``lpips_lambda > 0`` and no
LPIPS weights the run is refused unless ``--allow_random_lpips``.
Checkpoints go to ``exp_dir/step_*.pt`` (model, ``latent_avg``,
``avg_image``, optimizer, step); SIGTERM/SIGINT finish the step in flight,
save, and return (the handlers are restored), and ``--resume`` continues
from the newest checkpoint. ``run`` is the run loop, shared with
``train_stage2_e4e``.
"""

from __future__ import annotations

import argparse
import os
import signal

import numpy as np
import torch


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
    ap.add_argument("--w_norm_lambda", type=float, default=0.0)
    ap.add_argument("--stylegan_weights", default=None,
                    help="stage-1 run directory (its g_ema), or a torch "
                    "StyleGAN2-ADA checkpoint (G.* keys)")
    ap.add_argument("--lpips_weights", default=None,
                    help="torch.save'd LPIPS state_dict (net.*, lin.*)")
    ap.add_argument("--save_interval", type=int, default=1000)
    ap.add_argument("--image_interval", type=int, default=100,
                    help="save input/target/output face grids every N steps")
    ap.add_argument("--image_display_count", type=int, default=2)
    ap.add_argument("--val_root", default=None,
                    help="validation root; enables periodic validation and "
                    "best-checkpoint tracking on the validation loss")
    ap.add_argument("--val_interval", type=int, default=1000)
    ap.add_argument("--val_max_batches", type=int, default=20)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in exp_dir")
    ap.add_argument("--allow_random_lpips", action="store_true",
                    help="use RANDOM LPIPS features when no --lpips_weights "
                    "is given (debug only)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _batches(ds, order, batch_size, device):
    for i in range(0, len(order) - batch_size + 1, batch_size):
        items = [ds[j] for j in order[i: i + batch_size]]
        yield tuple(torch.from_numpy(np.stack([it[k] for it in items]))
                    .to(device) for k in (0, 1))


def lpips_from_args(args, device):
    """The LPIPS-alex loss of ``--lpips_weights``, RANDOM features with
    ``--allow_random_lpips``, or None at ``--lpips_lambda 0``; refuses a
    positive lambda without either."""
    from ..losses.perceptual import LPIPS
    from ..nn.initializers import init_weights

    if args.lpips_lambda <= 0:
        return None
    lpips_fn = LPIPS("alex")
    if args.lpips_weights:
        lpips_fn.load_state_dict(torch.load(
            args.lpips_weights, map_location="cpu", weights_only=True))
    elif args.allow_random_lpips:
        print("[warn] --allow_random_lpips: using RANDOM LPIPS features "
              "(debug only)")
        init_weights(lpips_fn, torch.Generator().manual_seed(99))
    else:
        raise SystemExit(
            "lpips_lambda > 0 but no --lpips_weights given: pass the "
            "LPIPS weights, or --lpips_lambda 0, or opt in to random "
            "features with --allow_random_lpips (debug only)")
    return lpips_fn.requires_grad_(False).eval().to(device)


def main(argv=None):
    args = _parse(argv)

    from ..train.stage2 import Stage2Coach, Stage2Config
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = Stage2Config(output_size=args.output_size,
                       n_iters_per_batch=args.n_iters_per_batch,
                       l2_lambda=args.l2_lambda,
                       lpips_lambda=args.lpips_lambda,
                       w_norm_lambda=args.w_norm_lambda,
                       learning_rate=args.learning_rate)
    coach = Stage2Coach(cfg, lpips_fn=lpips_from_args(args, device),
                        device=str(device))
    noise = torch.Generator(device).manual_seed(3)
    run(args, coach, device,
        lambda step, x, y, avg: coach.train_step(x, y, avg, noise), noise)


def run(args, coach, device, train_step, noise):
    """The training run of ``coach``: ``--resume`` from the newest
    checkpoint in exp_dir (with ``avg_image.npy``) or the generator of
    ``--stylegan_weights`` and a new latent average and average image,
    then ``train_step(step, x, y, avg_image)`` -> (loss, logs, y_hat) over
    shuffled batches with logging, face grids, validation (noise from
    ``noise``), checkpoints and preemption."""
    from ..data.images_dataset import ImagesDataset
    from ..utils.checkpoint import CheckpointManager, load_generator_handoff
    from ..utils.preempt import install_preemption_handler

    os.makedirs(args.exp_dir, exist_ok=True)
    mgr = CheckpointManager(args.exp_dir)
    avg_path = os.path.join(args.exp_dir, "avg_image.npy")
    start_step = 0
    if args.resume:
        latest = mgr.latest()
        if latest is None:
            raise SystemExit(f"--resume: no checkpoint under {args.exp_dir}")
        ckpt = torch.load(latest, map_location="cpu", weights_only=True)
        coach.load_state_dict(ckpt)
        meta = ckpt["metadata"]
        del ckpt
        # a preempted save is labelled with the next step to run, a
        # periodic one with the step it completed
        start_step = meta.get("step", 0) + (0 if meta.get("preempted")
                                            else 1)
        print(f"[resume] from {latest}, step {start_step}"
              + (" (preempted run)" if meta.get("preempted") else ""))
        if not os.path.exists(avg_path):
            raise SystemExit(f"--resume: {avg_path} missing (written at the "
                             "start of the original run)")
        avg_image = torch.from_numpy(np.load(avg_path))
    else:
        if args.stylegan_weights:
            source = load_generator_handoff(args.stylegan_weights,
                                            coach.model.decoder)
            print(f"[init] loaded generator weights ({source}) from "
                  f"{args.stylegan_weights}")
        coach.estimate_latent_avg(torch.Generator(device).manual_seed(1))
        avg_image = coach.make_avg_image().cpu()
        np.save(avg_path, avg_image.numpy())
    avg_image = avg_image.to(device)

    ds = ImagesDataset(args.source_root, args.target_root)
    print(f"[data] {len(ds)} pairs")
    if len(ds) < args.batch_size:
        raise SystemExit(f"dataset has {len(ds)} pairs < batch_size "
                         f"{args.batch_size}: no full batch can form")
    val_ds = ImagesDataset(args.val_root) if args.val_root else None
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    stop = install_preemption_handler(tuple(handlers))
    try:
        _train(args, coach, mgr, ds, val_ds, avg_image, start_step, stop,
               device, train_step, noise)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _train(args, coach, mgr, ds, val_ds, avg_image, start_step, stop,
           device, train_step, noise):
    from ..eval.inference import face_grid
    from ..utils.logging import MetricLogger

    def validate(max_batches):
        return coach.validate(
            _batches(val_ds, np.arange(len(val_ds)), args.batch_size, device),
            avg_image, noise, max_batches=max_batches)

    def payload():
        return dict(coach.state_dict(), avg_image=avg_image.cpu())

    rng = np.random.default_rng(start_step)
    step = start_step
    with MetricLogger(os.path.join(args.exp_dir, "logs")) as logger:
        if val_ds is not None and not args.resume:
            validate(5)     # step-0 sanity pass; its numbers are discarded
        while step < args.max_steps and not stop.is_set():
            for x, y in _batches(ds, rng.permutation(len(ds)),
                                 args.batch_size, device):
                loss, logs, y_hat = train_step(step, x, y, avg_image)
                if step % 50 == 0:
                    logger.log(step, logs, prefix="train/")
                if args.image_interval and step % args.image_interval == 0:
                    n = min(args.image_display_count, x.shape[0])
                    logger.log_image("images/train/faces", face_grid(
                        [{"input_face": x[i], "target_face": y[i],
                          "output_face": y_hat[i]} for i in range(n)]), step)
                val_loss = None
                if (val_ds is not None and step > 0
                        and step % args.val_interval == 0):
                    vlogs = validate(args.val_max_batches)
                    logger.log(step, vlogs, prefix="val/")
                    val_loss = vlogs.get("loss")
                if step % args.save_interval == 0 and step > 0:
                    # best tracking on the validation loss; on the train
                    # loss only when there is no validation set
                    metric = val_loss if val_ds is not None else float(loss)
                    mgr.save(step, payload(), metric=metric)
                step += 1
                if step >= args.max_steps or stop.is_set():
                    break
        if stop.is_set():
            mgr.save(step, payload(), metadata={"preempted": True})
            print(f"[preempt] checkpoint at step {step}; resume with "
                  "--resume", flush=True)
            return
        # the last step always leaves a loadable checkpoint
        mgr.save(step - 1, payload())


if __name__ == "__main__":
    main()
