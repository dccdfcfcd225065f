"""Stage-1 StyleGAN2-ADA GAN pretraining.

    python -m stylegan_for_facerec_torch.tools.train_stage1 \\
        --data_root faces/ --exp_dir runs/s1 \\
        [--config configs/stage1_stylegan2_ada.json] [--max_steps N] \\
        [--fid_interval N --fid_n 256 --fid_encoder stage3.pt] \\
        [--device cuda|cpu] [--resume]

The flags of the JAX package's ``tools/train_stage1.py`` plus ``--device``
(the GPU unless ``--device cpu``; raises when no GPU is found);
``--fid_inception`` is not ported (no InceptionV3 in this package); the
configuration's ``compute_dtype`` picks f32 or bf16 compute. Images come from ``data/images_dataset.py::
InferenceDataset`` at the configured size. Every 2000 steps, on
SIGTERM/SIGINT (after the step in flight; the handlers are restored) and
at the end, the full trainer state goes to ``exp_dir/step_*.pt``
(``Stage1Trainer.state_dict``); ``--resume`` continues from the newest
one, and ``tools/train_stage2.py --stylegan_weights exp_dir`` takes its
``g_ema``. ``--fid_interval`` reports FID between g_ema samples and reals
in the feature space of an IR-SE-50 at 112 px: the backbone of a stage-3
checkpoint of this package (``--fid_encoder``), or seeded random weights,
which track progress within one run only.
"""

from __future__ import annotations

import argparse
import signal

import numpy as np
import torch


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True,
                    help="unlabelled face images (any folder tree)")
    ap.add_argument("--exp_dir", required=True)
    ap.add_argument("--config", default=None,
                    help="Stage1Config JSON/YAML (default: the "
                    "configs/stage1_stylegan2_ada.json recipe)")
    ap.add_argument("--image_size", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in exp_dir")
    ap.add_argument("--fid_interval", type=int, default=0,
                    help="every N steps, FID between g_ema samples and "
                    "reals in IR-SE-50 feature space")
    ap.add_argument("--fid_n", type=int, default=256,
                    help="images per side of the FID estimate")
    ap.add_argument("--fid_encoder", default=None,
                    help="stage-3 checkpoint of this package whose backbone "
                    "is an IR-SE-50 at 112 (default: seeded random "
                    "weights, for progress within one run only)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _fid_fn(args, trainer, ds, device):
    """``compute_fid(step) -> float``: ``fid_n`` reals against ``fid_n``
    g_ema samples (z and noise from seeded generators)."""
    from ..eval.fid import embedding_fid
    from ..models.irse import IR_SE_50
    from ..nn.initializers import init_weights
    from ..ops.image import resize_bilinear
    from ..utils.checkpoint import load_backbone

    if args.fid_n < 2:
        raise SystemExit("--fid_n must be >= 2 (a covariance needs two "
                         "samples a side)")
    enc = IR_SE_50(112)
    if args.fid_encoder:
        load_backbone(args.fid_encoder, enc)
    else:
        print("[fid] no --fid_encoder: seeded random IR-SE-50 features; "
              "the metric tracks progress within this run only")
        init_weights(enc, torch.Generator().manual_seed(11))
    enc = enc.to(device).eval()
    bs = min(32, args.fid_n)
    n = (args.fid_n // bs) * bs

    @torch.no_grad()
    def embed(images):                                  # NHWC
        x = torch.as_tensor(images, device=device).permute(0, 3, 1, 2)
        return enc(resize_bilinear(x.float(), 112, 112))

    def compute_fid(step):
        rng = np.random.default_rng(step)
        reals = np.stack([ds[j] for j in rng.permutation(len(ds))[:n]])
        gen = torch.Generator(device).manual_seed(step)
        fakes = []
        with torch.no_grad():
            for _ in range(n // bs):
                z = torch.randn((bs, trainer.cfg.z_dim), generator=gen,
                                device=device)
                fakes.append(trainer.g_ema(z, generator=gen).float()
                             .permute(0, 2, 3, 1))
        return embedding_fid(embed, reals, torch.cat(fakes), batch_size=bs)

    return compute_fid


def main(argv=None):
    args = _parse(argv)

    from ..data.images_dataset import InferenceDataset
    from ..train.stage1 import Stage1Trainer
    from ..utils.checkpoint import CheckpointManager
    from ..utils.config import Stage1Config, load_config
    from ..utils.device import resolve_device
    from ..utils.preempt import install_preemption_handler

    device = resolve_device(args.device)
    cfg = (load_config(Stage1Config, args.config) if args.config else
           Stage1Config(image_size=args.image_size,
                        batch_size=args.batch_size))
    trainer = Stage1Trainer(cfg, device=str(device))
    ds = InferenceDataset(args.data_root, size=cfg.image_size)
    print(f"[data] {len(ds)} images")
    if len(ds) < cfg.batch_size:
        raise SystemExit(f"dataset has {len(ds)} images < batch_size "
                         f"{cfg.batch_size}: no full batch can form")
    mgr = CheckpointManager(args.exp_dir)
    start_step = 0
    if args.resume:
        latest = mgr.latest()
        if latest is None:
            raise SystemExit(f"--resume: no checkpoint under {args.exp_dir}")
        ckpt = torch.load(latest, map_location="cpu", weights_only=True)
        trainer.load_state_dict(ckpt)
        meta = ckpt["metadata"]
        # a preempted save is labelled with the next step to run, the
        # others with the step they completed
        start_step = meta.get("step", 0) + (0 if meta.get("preempted")
                                            else 1)
        print(f"[resume] from {latest}, step {start_step}"
              + (" (preempted run)" if meta.get("preempted") else ""))
    compute_fid = (_fid_fn(args, trainer, ds, device)
                   if args.fid_interval > 0 else None)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    stop = install_preemption_handler(tuple(handlers))
    try:
        _train(args, cfg, trainer, mgr, ds, start_step, stop, compute_fid,
               device)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _train(args, cfg, trainer, mgr, ds, start_step, stop, compute_fid,
           device):
    max_steps = args.max_steps or cfg.num_epochs * cfg.batches_per_epoch
    rng = np.random.default_rng(start_step)
    step = start_step
    while step < max_steps and not stop.is_set():
        order = rng.permutation(len(ds))
        for i in range(0, len(order) - cfg.batch_size + 1, cfg.batch_size):
            reals = torch.from_numpy(np.stack(
                [ds[j] for j in order[i: i + cfg.batch_size]])).to(device)
            logs = trainer.train_step(reals, step=step)
            if step % 50 == 0:
                print(f"step {step} " + " ".join(
                    f"{k} {float(v):.4f}" for k, v in logs.items()),
                    flush=True)
            if step % 2000 == 0 and step > 0:
                mgr.save(step, trainer.state_dict())
            if (compute_fid is not None and step > 0
                    and step % args.fid_interval == 0):
                print(f"step {step} fid512 {compute_fid(step):.3f}",
                      flush=True)
            step += 1
            if step >= max_steps or stop.is_set():
                break
    if stop.is_set():
        mgr.save(step, trainer.state_dict(), metadata={"preempted": True})
        print(f"[preempt] checkpoint at step {step}; resume with --resume",
              flush=True)
        return
    # the last step always leaves a loadable, resumable checkpoint
    mgr.save(step - 1, trainer.state_dict())


if __name__ == "__main__":
    main()
