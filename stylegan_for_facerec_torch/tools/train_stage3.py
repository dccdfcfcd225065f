"""Stage-3 face-recognition training.

    python -m stylegan_for_facerec_torch.tools.train_stage3 \\
        --config configs/stage3_bupt_ir50.json \\
        [--encoder_checkpoint runs/s2/step_000100000.pt] [--avg_image a.npy] \\
        [--packed_dir shards/] [--max_steps N] [--resume] \\
        [--randaugment N_OPS] [--fast_decode] \\
        [--compute_dtype bfloat16|float32] [--remat] [--device cuda|cpu]
    torchrun --nproc_per_node N -m stylegan_for_facerec_torch.tools.\
        train_stage3 --config ... --packed_dir shards/ [--mesh_model_axis M]

The JAX package's ``tools/train_stage3.py`` on one GPU (the card unless
``--device cpu``; raises when no GPU is found), or under ``torchrun``
data- and class-parallel over N processes, one card each: a
``parallel.mesh`` of N / M data ranks by M model ranks (the head's
classes split over M), the batch rounded down to a multiple of N / M
(said so), each rank loading its slice of every global batch from packed
shards (the decode loader is refused), and only rank 0 logging,
evaluating and writing checkpoints (the other ranks join in gathering
the head for them). With one process it is the one-GPU CLI.
``--config`` is a JSON or YAML ``Stage3Options`` file or a reference
python config. The backbone (``build_backbone``: ``pSp``, a
``PSpFaceRec`` with the config's block dropout; an IR/IR-SE
``Backbone``, a ``ResNet_50/101/152`` or a ``MobileFaceNet`` by name)
trains with the config's margin head, focal loss and SGD; the body is
frozen while ``epoch <= freeze_backbone_epochs`` (0-based epochs); a
ResNet or MobileFaceNet has no body, so, as in the JAX package, it
trains whole in those epochs too. ``--remat`` recomputes the backbone's
forward in the backward pass. ``--encoder_checkpoint`` (pSp
only) hands a stage-2 encoder's ``input_layer`` and ``body`` to the
backbone (``load_encoder_handoff``): a directory is a JAX package run or
checkpoint directory (read without JAX, its ``avg_image.npy`` taken); a
file is a stage-2 checkpoint of this package or a reference torch ``.pt``
(a state_dict, bare or under ``state_dict``, with the reference's
``encoder.*`` names). The stage-2 average image becomes the backbone's
unless ``--avg_image`` or the config names one (.npy (H, W, 3) in
[-1, 1], or an image file). Images come from ``--packed_dir`` (or a packed
``data_root/train_subdir``) as uint8 shards, else from the image tree
through ``make_loader`` (the C++ loader where it can take the tree, with
``--fast_decode`` its DCT-scaled JPEG decode; the Python loader with
``--randaugment``, whose N operations an image run on the host and which
packed shards refuse); the crop to the input size and the flip run in the
train step. After each epoch every ``eval_benchmarks`` set found
as ``data_root/<name>.npz`` is verified, its accuracy, threshold and ROC
curve image (``logs/<name>_ROC_Curve/<step>.jpg``; skipped, said once,
where matplotlib is not installed) logged, and a checkpoint is written
under ``model_root/name``; SIGTERM/SIGINT save mid-epoch, and ``--resume``
continues from the newest checkpoint (a preempted epoch replays its
loader permutation and skips the batches it had taken).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
    ap.add_argument("--randaugment", type=int, default=0, metavar="N_OPS",
                    help="host RandAugment with N_OPS operations an image "
                    "(the Python loader; not on packed shards)")
    ap.add_argument("--fast_decode", action="store_true",
                    help="the C++ loader decodes large JPEGs at the coarsest "
                    "1/2^k DCT scale covering the image size; pixels differ "
                    "slightly from a full decode")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--remat", action="store_true",
                    help="recompute the backbone's forward in the backward "
                    "pass (less activation memory)")
    ap.add_argument("--mesh_model_axis", type=int, default=1,
                    help="under torchrun: ranks the head's classes split "
                    "over")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def data_parallel_setup(model_axis: int, batch_size: int, device: str):
    """(mesh, global batch) of a ``torchrun`` run (the environment's), or
    (None, batch_size) for one process. The batch is rounded down to a
    multiple of the data axis, as the JAX CLI does, and said so."""
    from ..parallel.mesh import initialize_distributed_from_env, make_mesh
    if not initialize_distributed_from_env():
        if model_axis != 1:
            raise SystemExit("--mesh_model_axis splits the head over "
                             "torchrun processes; this is one process")
        return None, batch_size
    mesh = make_mesh(model=model_axis, device=device)
    data = mesh.shape["data"]
    if mesh.is_main:
        print(f"[dist] {mesh.world.size} processes, mesh data {data} x model "
              f"{mesh.shape['model']}, backend {mesh.backend}", flush=True)
    if batch_size % data:
        new_bs = max(data, batch_size // data * data)
        if mesh.is_main:
            print(f"[mesh] batch_size {batch_size} is not divisible by the "
                  f"{data}-rank data axis; using {new_bs}", flush=True)
        batch_size = new_bs
    return mesh, batch_size


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
    ``avg_image``; its run directory gives the newest) or a reference
    torch ``.pt``."""
    from ..utils.checkpoint import (load_stage2_encoder, read_jax_checkpoint,
                                    resolve_checkpoint_dir)
    from ..utils.convert import load_stage2_encoder_from_jax
    resolved = resolve_checkpoint_dir(path)
    if os.path.isdir(resolved):
        load_stage2_encoder_from_jax(backbone, read_jax_checkpoint(path))
        avg = os.path.join(path, "avg_image.npy")
        return _avg_image(avg) if os.path.exists(avg) else None
    ckpt = torch.load(resolved, map_location="cpu", weights_only=True)
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

    from ..data.dataset import FacesDataset
    from ..data.native_loader import make_loader
    from ..data.packed import (PackedLoader, PackedTrainDataset,
                               is_packed_dir)
    from ..models.psp import PSpFaceRec
    from ..train.stage3 import Stage3Config, Stage3Trainer
    from ..utils.checkpoint import CheckpointManager
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    opts = load_options(args.config)
    mesh, batch = data_parallel_setup(args.mesh_model_axis, opts.batch_size,
                                      str(device))
    opts = dataclasses.replace(opts, batch_size=batch)
    say = print if mesh is None or mesh.is_main else (lambda *a, **k: None)
    train_root = os.path.join(opts.data_root, opts.train_subdir)
    packed_dir = args.packed_dir
    if packed_dir is None and is_packed_dir(train_root):
        packed_dir = train_root
    if packed_dir is not None:
        if args.randaugment > 0:
            raise SystemExit("--randaugment needs the decoding loader; it "
                             "cannot run on packed uint8 shards")
        ds = PackedTrainDataset(packed_dir)
        if ds.image_size < opts.input_size[0]:
            raise SystemExit(f"packed shards are {ds.image_size} px, below "
                             f"the input size {opts.input_size[0]}")
        loader = PackedLoader(
            ds, opts.batch_size, drop_last=opts.drop_last or mesh is not None,
            process_id=0 if mesh is None else mesh.data.index,
            num_processes=1 if mesh is None else mesh.data.size)
        say(f"[data] packed: {len(ds)} images, {ds.n_identities} "
            f"identities from {packed_dir}")
    elif mesh is not None:
        raise SystemExit("multi-process training feeds through packed "
                         "shards (tools/pack_train.py + --packed_dir); the "
                         "decoding loader has no cross-process batch "
                         "contract")
    else:
        # resize scaled with the input size (128 for 112), then the crop
        ds_size = max(opts.input_size[0],
                      round(128 * opts.input_size[0] / 112))
        transform = None
        if args.randaugment > 0:
            from ..data.randaugment import RandAugment
            transform = RandAugment(num_ops=args.randaugment)
            print(f"[data] RandAugment({args.randaugment} ops)")
        ds = FacesDataset(train_root, image_size=ds_size, transform=transform)
        loader = make_loader(ds, opts.batch_size,
                             num_workers=opts.num_workers,
                             drop_last=opts.drop_last,
                             fast_decode=args.fast_decode)
        print(f"[data] {len(ds)} images, {ds.n_identities} identities "
              f"(resize {ds_size} -> crop {opts.input_size[0]}) through "
              f"{type(loader).__name__}")
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
                            device=str(device), mesh=mesh)

    avg_path = args.avg_image or opts.avg_image
    enc_path = args.encoder_checkpoint or opts.encoder_checkpoint
    if enc_path:
        if opts.backbone != "pSp":
            raise SystemExit("--encoder_checkpoint loads into the pSp "
                             "backbone only")
        avg = load_encoder_handoff(backbone, enc_path)
        say(f"[init] stage-2 encoder input_layer and body from {enc_path}")
        if not avg_path and avg is not None:
            with torch.no_grad():
                backbone.avg_image.copy_(avg.permute(2, 0, 1))
            say("[init] avg image from the stage-2 checkpoint")
    if avg_path and isinstance(backbone, PSpFaceRec):
        with torch.no_grad():
            backbone.avg_image.copy_(_avg_image(avg_path).permute(2, 0, 1))
        say(f"[init] avg image from {avg_path}")

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
                say(f"[resume] replaying loader permutation "
                    f"{loader._epoch}")
            else:
                say("[resume] WARNING: the loader seed changed since the "
                    "preempted run; the epoch's coverage will be uneven")
            say(f"[resume] preempted run {latest}: epoch {start_epoch} "
                f"from step {resume_step}")
        else:
            start_epoch = meta["epoch"] + 1
            say(f"[resume] from {latest}, epoch {start_epoch}")

    from ..eval.verify_runner import load_val_pair
    val_data = {}
    for name in opts.eval_benchmarks:
        try:
            val_data[name] = load_val_pair(os.path.join(opts.data_root,
                                                        name))
        except FileNotFoundError:
            say(f"[eval] {name}.npz not found; skipping")

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    stop = install_preemption_handler(tuple(handlers))
    try:
        _train(args, opts, trainer, loader, mgr, val_data, start_epoch,
               resume_step, steps_per_epoch, stop, device, mesh)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def _train(args, opts, trainer, loader, mgr, val_data, start_epoch,
           resume_step, steps_per_epoch, stop, device, mesh=None):
    from ..data.packed import device_prefetch
    from ..eval.verify_runner import perform_val
    from ..utils.logging import AverageMeter, MetricLogger

    step = resume_step if resume_step is not None \
        else start_epoch * steps_per_epoch
    main_rank = mesh is None or mesh.is_main
    plots = importlib.util.find_spec("matplotlib") is not None
    if val_data and not plots and main_rank:
        print("[eval] matplotlib is not installed: the ROC curve images "
              "are skipped; accuracy and thresholds are still logged")

    def stopping() -> bool:
        # ranks stop at the same step: under a mesh they agree every 10
        if mesh is None:
            return stop.is_set()
        return step % 10 == 0 and mesh.any(stop.is_set())

    logs = MetricLogger(os.path.join(mgr.root, "logs")) if main_rank \
        else contextlib.nullcontext(_NoLogger())
    with logs as logger:
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

            stopped = False
            for images, labels in batch_iter:
                metrics = trainer.train_step(images, labels, step, mask)
                if pending is not None:
                    drain(pending)
                pending = (step, metrics)
                step += 1
                stopped = stopping()
                if (args.max_steps and step >= args.max_steps) or stopped:
                    break
            if pending is not None:
                drain(pending)
            if stopped:
                state = trainer.state_dict()
                if main_rank:
                    mgr.save(step, state, metadata={
                        "epoch": epoch, "step": step, "preempted": True,
                        "loader_epoch": loader_perm,
                        "loader_seed": loader.seed})
                    print(f"[preempt] checkpoint at step {step} (epoch "
                          f"{epoch}); resume with --resume", flush=True)
                return
            dt = time.time() - t0
            logger.log(step, {"train_loss_ep": losses.avg,
                              "train_acc_ep": top1.avg,
                              "train_acc_top5_ep": top5.avg, "epoch": epoch,
                              "epoch_seconds": dt,
                              "imgs_per_sec": losses.count * opts.batch_size
                              / max(dt, 1e-9)})
            for name, (carray, issame) in (val_data.items() if main_rank
                                           else ()):
                acc, thr, roc = perform_val(
                    trainer.backbone, carray, issame,
                    batch_size=min(256, len(carray)), emb_size=opts.emb_size,
                    device=str(device))
                logger.log_benchmark(step, name, acc, thr, epoch=epoch,
                                     roc=roc if plots else None)
            state = trainer.state_dict()
            if main_rank:
                mgr.save(step, state, metadata={"epoch": epoch})
            if args.max_steps and step >= args.max_steps:
                break


class _NoLogger:
    """A rank other than 0 logs nothing."""

    def log(self, *args, **kwargs):
        pass

    def log_benchmark(self, *args, **kwargs):
        pass


if __name__ == "__main__":
    main()
