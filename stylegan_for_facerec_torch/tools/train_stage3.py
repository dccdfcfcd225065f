"""Stage-3 face-recognition training.

    python -m stylegan_for_facerec_torch.tools.train_stage3 \\
        --config configs/stage3_bupt_ir50.json \\
        [--encoder_checkpoint runs/s2/step_000100000.pt] [--avg_image a.npy] \\
        [--packed_dir shards/] [--max_steps N] [--resume] \\
        [--compute_dtype bfloat16|float32] [--remat] [--device cuda|cpu]

The JAX package's ``tools/train_stage3.py`` on one GPU (the card unless
``--device cpu``; raises when no GPU is found). ``--config`` is a JSON or
YAML ``Stage3Options`` file or a reference python config. The backbone
(``build_backbone``: ``pSp``, a ``PSpFaceRec`` with the config's block
dropout; an IR/IR-SE ``Backbone``, a ``ResNet_50/101/152`` or a
``MobileFaceNet`` by name) trains with the config's margin head, focal
loss and SGD; the body is frozen while ``epoch <= freeze_backbone_epochs``
(0-based epochs); a ResNet or MobileFaceNet has no body, so, as in the JAX
package, it trains whole in those epochs too. ``--remat`` recomputes the
backbone's forward in the backward pass. ``--encoder_checkpoint`` (pSp
only) hands a stage-2 encoder's ``input_layer`` and ``body`` to the
backbone (``load_encoder_handoff``): a directory is a JAX package run or
checkpoint directory (read without JAX, its ``avg_image.npy`` taken); a
file is a stage-2 checkpoint of this package or a reference torch ``.pt``
(a state_dict, bare or under ``state_dict``, with the reference's
``encoder.*`` names). The stage-2 average image becomes the backbone's
unless ``--avg_image`` or the config names one (.npy (H, W, 3) in
[-1, 1], or an image file). Images come from ``--packed_dir`` (or a packed
``data_root/train_subdir``) as uint8 shards, else from the image tree
through the threaded loader; the crop to the input size and the flip run
in the train step. After each epoch every ``eval_benchmarks`` set found
as ``data_root/<name>.npz`` is verified and a checkpoint is written under
``model_root/name``; SIGTERM/SIGINT save mid-epoch, and ``--resume``
continues from the newest checkpoint (a preempted epoch replays its
loader permutation and skips the batches it had taken).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from ..utils.preempt import install_preemption_handler


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--max_steps", type=int, default=None,
                    help="cap on the total number of steps")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in "
                    "model_root/name")
    ap.add_argument("--packed_dir", default=None,
                    help="uint8 shard directory (data/packed.py layout)")
    ap.add_argument("--encoder_checkpoint", default=None,
                    help="stage-2 checkpoint of this package, reference "
                    "torch .pt or JAX run directory (overrides the "
                    "config's)")
    ap.add_argument("--avg_image", default=None,
                    help="average image (overrides the config's and the "
                    "stage-2 checkpoint's)")
    ap.add_argument("--no_prefetch", action="store_true",
                    help="copy each batch to the card when it is used")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--remat", action="store_true",
                    help="recompute the backbone's forward in the backward "
                    "pass (less activation memory)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_options(path):
    from ..utils.config import Stage3Options, from_reference_stage3, \
        load_config
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location("usercfg", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return from_reference_stage3(mod.configurations)
    return load_config(Stage3Options, path)


BACKBONES = ("pSp", "MobileFaceNet", "IR_50", "IR_101", "IR_152",
             "IR_SE_50", "IR_SE_101", "IR_SE_152", "ResNet_50", "ResNet_101",
             "ResNet_152")


def build_backbone(opts):
    """The backbone ``opts.backbone`` names (``BACKBONES``, the names the
    JAX package's stage-3 CLI builds): ``pSp`` (the paper's backbone, with
    the config's block dropout), ``MobileFaceNet``, an IR/IR-SE
    ``Backbone`` or a ``ResNet`` (dropout 0.5 before its embedding, as the
    JAX CLI builds it) at ``opts.input_size``; another name raises
    ``SystemExit``."""
    from ..models import irse, mobilefacenet, psp, resnet
    name, size = opts.backbone, opts.input_size[0]
    if name not in BACKBONES:
        raise SystemExit(f"unknown backbone {name}")
    if name == "pSp":
        return psp.PSpFaceRec(size=size, emb_size=opts.emb_size,
                              block_dropout=opts.dropout or None)
    if name == "MobileFaceNet":
        return mobilefacenet.MobileFaceNet(embedding_size=opts.emb_size)
    module = resnet if name.startswith("ResNet_") else irse
    return getattr(module, name)(size, emb_size=opts.emb_size)


def load_encoder_handoff(backbone, path: str) -> Optional[torch.Tensor]:
    """Load a stage-2 encoder's ``input_layer`` and ``body`` into a
    ``PSpFaceRec`` strictly (its output layer keeps its own weights) and
    return the stage-2 average image ((H, W, 3) in [-1, 1]) or None. A
    directory is a JAX package run or checkpoint directory (npz, read
    without JAX; its ``avg_image.npy``); a file is a ``torch.save`` state
    dict, bare or under ``state_dict``, with the reference's
    ``encoder.*`` names: a stage-2 checkpoint of this package (with its
    ``avg_image``) or a reference torch ``.pt``."""
    from ..utils.checkpoint import load_stage2_encoder, read_jax_checkpoint
    from ..utils.convert import load_stage2_encoder_from_jax
    if os.path.isdir(path):
        load_stage2_encoder_from_jax(backbone, read_jax_checkpoint(path))
        avg = os.path.join(path, "avg_image.npy")
        return _avg_image(avg) if os.path.exists(avg) else None
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_stage2_encoder(backbone, ckpt.get("state_dict", ckpt))
    avg = ckpt.get("avg_image")
    return avg if torch.is_tensor(avg) else None


def _avg_image(path: str) -> torch.Tensor:
    """(H, W, 3) in [-1, 1] from a .npy or an image file."""
    if path.endswith(".npy"):
        return torch.from_numpy(np.load(path).astype(np.float32))
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return torch.from_numpy((img - 0.5) / 0.5)


def main(argv=None):
    args = _parse(argv)

    from ..data.dataset import DataLoader, FacesDataset
    from ..data.packed import (PackedLoader, PackedTrainDataset,
                               is_packed_dir)
    from ..models.psp import PSpFaceRec
    from ..train.stage3 import Stage3Config, Stage3Trainer
    from ..utils.checkpoint import CheckpointManager
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    opts = load_options(args.config)
    train_root = os.path.join(opts.data_root, opts.train_subdir)
    packed_dir = args.packed_dir
    if packed_dir is None and is_packed_dir(train_root):
        packed_dir = train_root
    if packed_dir is not None:
        ds = PackedTrainDataset(packed_dir)
        if ds.image_size < opts.input_size[0]:
            raise SystemExit(f"packed shards are {ds.image_size} px, below "
                             f"the input size {opts.input_size[0]}")
        loader = PackedLoader(ds, opts.batch_size, drop_last=opts.drop_last)
        print(f"[data] packed: {len(ds)} images, {ds.n_identities} "
              f"identities from {packed_dir}")
    else:
        # resize scaled with the input size (128 for 112), then the crop
        ds_size = max(opts.input_size[0],
                      round(128 * opts.input_size[0] / 112))
        ds = FacesDataset(train_root, image_size=ds_size)
        loader = DataLoader(ds, opts.batch_size,
                            num_workers=opts.num_workers,
                            drop_last=opts.drop_last)
        print(f"[data] {len(ds)} images, {ds.n_identities} identities "
              f"(resize {ds_size} -> crop {opts.input_size[0]})")
    if len(ds) == 0 or ds.n_identities == 0:
        raise SystemExit(f"no training images found under {train_root}")
    steps_per_epoch = len(loader)
    if steps_per_epoch == 0:
        raise SystemExit(f"dataset ({len(ds)} images) smaller than one "
                         f"batch ({opts.batch_size}) with drop_last")

    backbone = build_backbone(opts)
    cfg = Stage3Config(
        emb_size=opts.emb_size, num_classes=ds.n_identities, head=opts.head,
        loss="Focal" if opts.loss == "Focal" else "CE",
        arcface_s=opts.arcface_s, margin=opts.margin, lr=opts.lr,
        momentum=opts.momentum, weight_decay=opts.weight_decay,
        batch_size=opts.batch_size, num_epochs=opts.num_epochs,
        stages=tuple(opts.stages),
        warmup_batches=opts.warmup_epochs * steps_per_epoch,
        freeze_backbone_epochs=opts.freeze_backbone_epochs,
        compute_dtype=args.compute_dtype, remat=args.remat,
        augment_crop=opts.input_size[0])
    trainer = Stage3Trainer(backbone, cfg, steps_per_epoch=steps_per_epoch,
                            device=str(device))

    avg_path = args.avg_image or opts.avg_image
    enc_path = args.encoder_checkpoint or opts.encoder_checkpoint
    if enc_path:
        if opts.backbone != "pSp":
            raise SystemExit("--encoder_checkpoint loads into the pSp "
                             "backbone only")
        avg = load_encoder_handoff(backbone, enc_path)
        print(f"[init] stage-2 encoder input_layer and body from {enc_path}")
        if not avg_path and avg is not None:
            with torch.no_grad():
                backbone.avg_image.copy_(avg.permute(2, 0, 1))
            print("[init] avg image from the stage-2 checkpoint")
    if avg_path and isinstance(backbone, PSpFaceRec):
        with torch.no_grad():
            backbone.avg_image.copy_(_avg_image(avg_path).permute(2, 0, 1))
        print(f"[init] avg image from {avg_path}")

    mgr = CheckpointManager(os.path.join(opts.model_root, opts.name))
    start_epoch, resume_step = opts.start_epoch, None
    if args.resume:
        latest = mgr.latest()
        if latest is None:
            raise SystemExit(f"--resume: no checkpoint under {mgr.root}")
        ckpt = torch.load(latest, map_location="cpu", weights_only=True)
        trainer.load_state_dict(ckpt)
        meta = ckpt["metadata"]
        del ckpt
        if meta.get("preempted"):
            start_epoch, resume_step = meta["epoch"], meta["step"]
            if meta.get("loader_seed") == loader.seed:
                loader._epoch = meta["loader_epoch"]
                print(f"[resume] replaying loader permutation "
                      f"{loader._epoch}")
            else:
                print("[resume] WARNING: the loader seed changed since the "
                      "preempted run; the epoch's coverage will be uneven")
            print(f"[resume] preempted run {latest}: epoch {start_epoch} "
                  f"from step {resume_step}")
        else:
            start_epoch = meta["epoch"] + 1
            print(f"[resume] from {latest}, epoch {start_epoch}")

    from ..eval.verify_runner import load_val_pair
    val_data = {}
    for name in opts.eval_benchmarks:
        try:
            val_data[name] = load_val_pair(os.path.join(opts.data_root,
                                                        name))
        except FileNotFoundError:
            print(f"[eval] {name}.npz not found; skipping")

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    stop = install_preemption_handler(tuple(handlers))
    try:
        _train(args, opts, trainer, loader, mgr, val_data, start_epoch,
               resume_step, steps_per_epoch, stop, device)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _train(args, opts, trainer, loader, mgr, val_data, start_epoch,
           resume_step, steps_per_epoch, stop, device):
    from ..data.packed import device_prefetch
    from ..eval.verify_runner import perform_val
    from ..utils.logging import AverageMeter, MetricLogger

    step = resume_step if resume_step is not None \
        else start_epoch * steps_per_epoch
    with MetricLogger(os.path.join(mgr.root, "logs")) as logger:
        for epoch in range(start_epoch, opts.num_epochs):
            frozen = (opts.freeze_backbone_epochs > 0
                      and epoch <= opts.freeze_backbone_epochs)
            mask = trainer.freeze_mask(frozen)
            t0 = time.time()
            losses, top1, top5 = AverageMeter(), AverageMeter(), \
                AverageMeter()
            loader_perm = loader._epoch
            batch_iter = iter(loader)
            if resume_step is not None and epoch == start_epoch:
                for _ in range(resume_step - start_epoch * steps_per_epoch):
                    next(batch_iter, None)
            if args.no_prefetch:
                batch_iter = ((torch.from_numpy(x).to(device),
                               torch.from_numpy(y).to(device))
                              for x, y in batch_iter)
            else:
                batch_iter = device_prefetch(batch_iter, str(device))
            # a step's metrics are read after the next step is queued, so
            # reading them does not stall the card
            pending = None

            def drain(p):
                st, m = p
                vals = {k: float(v) for k, v in m.items()}
                losses.update(vals["loss"])
                top1.update(vals["top1"])
                top5.update(vals["top5"])
                if st % 10 == 0:
                    logger.log(st, {"train_loss": vals["loss"],
                                    "train_top1": vals["top1"],
                                    "train_top5": vals["top5"],
                                    "lr": vals["lr"], "epoch": epoch})

            for images, labels in batch_iter:
                metrics = trainer.train_step(images, labels, step, mask)
                if pending is not None:
                    drain(pending)
                pending = (step, metrics)
                step += 1
                if (args.max_steps and step >= args.max_steps) \
                        or stop.is_set():
                    break
            if pending is not None:
                drain(pending)
            if stop.is_set():
                mgr.save(step, trainer.state_dict(), metadata={
                    "epoch": epoch, "step": step, "preempted": True,
                    "loader_epoch": loader_perm, "loader_seed": loader.seed})
                print(f"[preempt] checkpoint at step {step} (epoch {epoch}); "
                      "resume with --resume", flush=True)
                return
            dt = time.time() - t0
            logger.log(step, {"train_loss_ep": losses.avg,
                              "train_acc_ep": top1.avg,
                              "train_acc_top5_ep": top5.avg, "epoch": epoch,
                              "epoch_seconds": dt,
                              "imgs_per_sec": losses.count * opts.batch_size
                              / max(dt, 1e-9)})
            for name, (carray, issame) in val_data.items():
                acc, thr, _ = perform_val(
                    trainer.backbone, carray, issame,
                    batch_size=min(256, len(carray)), emb_size=opts.emb_size,
                    device=str(device))
                logger.log_benchmark(step, name, acc, thr, epoch=epoch)
            mgr.save(step, trainer.state_dict(), metadata={"epoch": epoch})
            if args.max_steps and step >= args.max_steps:
                break


if __name__ == "__main__":
    main()
