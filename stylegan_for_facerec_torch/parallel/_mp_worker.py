"""Multi-process worker: the trainers' mesh paths run end to end over
several processes, the port of ``stylegan_for_facerec_tpu/parallel/
_mp_worker.py`` (a tiny stage-3 run over a multi-process mesh) extended
to the sharded head, BatchNorm, the sharded export, stage 1, stage 2,
e4e and spatially sharded synthesis.

Each task is a function ``task(mesh, args) -> dict`` that builds its model
from a seed, draws its global batches from a seed, steps the rank's slice
and returns what the comparison needs; with ``mesh=None`` the same
function is one process on the whole global batch, the reference. Tasks
are named ``<task>:<data>x<model>`` (the mesh) and run in order.

Run (CPU, two ranks; ``--world 1`` runs the one-process reference):

  python -m stylegan_for_facerec_torch.parallel._mp_worker --world 2 \\
      --rank 0 --init file:///tmp/sgfr_init --out /tmp/mp \\
      --tasks stage3:2x1 stage1:2x1 --device cpu &
  python -m stylegan_for_facerec_torch.parallel._mp_worker --world 2 \\
      --rank 1 --init file:///tmp/sgfr_init --out /tmp/mp \\
      --tasks stage3:2x1 stage1:2x1 --device cpu

or ``spawn(tasks, world, out)`` from Python (on the card unless the
caller passes ``device="cpu"``, as the CLI). ``--size micro`` builds the
models at micro widths (one IR unit a stage, 32 channels in G and D), and
``--size full`` at the recipes' widths (the card). ``--device cuda``
gives rank r card r; ``cuda:0`` puts every rank on card 0. Prints
``MPSTEP <task> <step> <loss>`` per step and ``MP_WORKER_OK`` at the
end; each rank saves its results to ``<out>/rank<r>.pt`` (rank 0 with
its end state, every rank with a digest of its own).
``tests/test_torch_parallel.py``, ``tests/test_torch_ddp.py``,
``tests/test_torch_spatial.py``, ``chip_smoke.py`` phases 43-45 and
``scripts/ddp_cards.py`` drive it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import hashlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
KINDS = ("arcface", "cosface", "softmax")


# -- sizes -----------------------------------------------------------------

@contextlib.contextmanager
def micro_widths(on: bool = True):
    """Models built inside have one IR unit a stage and 32 channels at
    every resolution of G and D (the module-level width tables are
    swapped for the duration)."""
    if not on:
        yield
        return
    from ..models import irse, psp, stylegan2, stylegan2_ada

    def blocks(num_layers):
        return ((64, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 2))

    saved = [(irse, "get_blocks"), (psp, "get_blocks"),
             (stylegan2_ada, "channels_for"),
             (stylegan2, "rosinality_channels")]
    old = [getattr(m, n) for m, n in saved]
    irse.get_blocks = psp.get_blocks = blocks
    stylegan2_ada.channels_for = lambda res, *a: dict.fromkeys(res, 32)
    stylegan2.rosinality_channels = lambda *a: dict.fromkeys(
        (4, 8, 16, 32, 64, 128, 256, 512, 1024), 32)
    try:
        yield
    finally:
        for (m, n), f in zip(saved, old):
            setattr(m, n, f)


def _launches() -> Dict[str, int]:
    from ..ops.fused_act import bias_act, bias_act_grad
    from ..ops.resample import smooth_upsample, smooth_upsample_grad
    return {f.__name__: f.launches for f in
            (bias_act, bias_act_grad, smooth_upsample, smooth_upsample_grad)}


def _minus(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    return {k: a[k] - b[k] for k in a}


def _rows(mesh, x: torch.Tensor) -> torch.Tensor:
    return x if mesh is None else mesh.data.local(x)


def _cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_cpu(v) for v in obj]
    return obj


def digest(tensors: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """SHA-256 of each tensor's bytes: equal digests, equal tensors."""
    return {k: hashlib.sha256(t.detach().cpu().reshape(-1).contiguous()
                              .view(torch.uint8).numpy()).hexdigest()
            for k, t in tensors.items()}


def _log(args, task, step, loss):
    print(f"MPSTEP {task} {step} {float(loss):.6f}", flush=True)


# -- the class-sharded head --------------------------------------------------

HEAD_B, HEAD_D, HEAD_C = 16, 32, 64


def head_inputs():
    """(features (16, 32), weight (64, 32), labels (16,)) from seed 5."""
    rng = np.random.RandomState(5)
    return (rng.randn(HEAD_B, HEAD_D).astype(np.float32),
            rng.randn(HEAD_C, HEAD_D).astype(np.float32),
            rng.randint(0, HEAD_C, HEAD_B).astype(np.int64))


def dense_margin_ce(f, w, labels, kind):
    """(mean CE, top-1) of the whole batch against all classes."""
    import torch.nn.functional as F

    from ..models.heads import arcface_margin, cosface_margin
    from .sharded_head import _normalize
    cosine = _normalize(f) @ _normalize(w).t()
    one_hot = F.one_hot(labels, w.shape[0]).to(cosine.dtype)
    if kind == "arcface":
        logits = arcface_margin(cosine, one_hot)
    elif kind == "cosface":
        logits = cosface_margin(cosine, one_hot)
    else:
        logits = cosine * 64.0
    ce = torch.logsumexp(logits, 1) - (logits * one_hot).sum(1)
    return ce.mean(), (logits.argmax(1) == labels).float().mean()


def task_head(mesh, args):
    """Each kind's loss, top-1, the feature gradient of the rank's rows
    and the shard gradient summed over the data axis; without a mesh the
    dense single-process values."""
    from .sharded_head import make_sharded_margin_ce
    feats, weight, labels = (torch.from_numpy(a) for a in head_inputs())
    out = {}
    for kind in KINDS:
        f = _rows(mesh, feats).clone().requires_grad_(True)
        w = weight if mesh is None else \
            weight[mesh.model.rows(HEAD_C)]
        w = w.clone().requires_grad_(True)
        lab = _rows(mesh, labels)
        if mesh is None:
            loss, top1 = dense_margin_ce(f, w, lab, kind)
        else:
            loss, top1 = make_sharded_margin_ce(mesh, HEAD_C, kind)(
                f, w, lab)
        loss.backward()
        if mesh is not None:
            mesh.data.sum_grads_([w])
        out[kind] = {"loss": loss, "top1": top1, "f_grad": f.grad,
                     "w_grad": w.grad}
    return out


# -- BatchNorm -----------------------------------------------------------------

BN_SHAPE = (8, 6, 5, 5)


def bn_inputs():
    rng = np.random.RandomState(7)
    x = rng.randn(*BN_SHAPE).astype(np.float32) * 2.0 + 0.5
    g = rng.randn(*BN_SHAPE).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def _bn_run(bn, x, g, mesh):
    x = x.clone().requires_grad_(True)
    y = bn(x)
    y.backward(g)
    grads = [bn.weight, bn.bias]
    if mesh is not None:
        mesh.data.sum_grads_(grads)
    return {"y": y, "x_grad": x.grad, "w_grad": bn.weight.grad,
            "b_grad": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


def task_bn(mesh, args):
    """BatchNorm2d(6) in train mode on (8, 6, 5, 5), weight and bias
    seeded, an upstream gradient: synchronized over the data axis
    (``sync``) and per replica with data index 0's statistics broadcast
    (``replica``). Without a mesh: one BatchNorm on the whole batch, and
    ghost BatchNorm with one group a data rank."""
    from ..nn.layers import BatchNorm2d
    x, g = bn_inputs()
    out = {}
    for mode in ("sync", "replica"):
        bn = BatchNorm2d(BN_SHAPE[1])
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, BN_SHAPE[1]))
            bn.bias.copy_(torch.linspace(-0.2, 0.3, BN_SHAPE[1]))
        if mesh is None:
            bn.bn_groups = None if mode == "sync" else args.n_data
        elif mode == "sync":
            bn.sync = mesh.data
        r = _bn_run(bn, _rows(mesh, x), _rows(mesh, g), mesh)
        if mesh is not None and mode == "replica":
            mesh.data.broadcast_(list(bn.buffers()))
            r["mean"], r["var"] = bn.running_mean.clone(), \
                bn.running_var.clone()
        out[mode] = r
    return out


# -- the sharded export ---------------------------------------------------

def export_backbone(size: str):
    """A seeded IR-SE backbone at 32 px (micro) or IR-SE-50 at 112 with
    BatchNorm statistics seeded, in eval mode."""
    from ..models.irse import Backbone
    from ..nn.initializers import init_weights
    with micro_widths(size == "micro"):
        side = 32 if size == "micro" else 112
        m = Backbone(input_size=side, num_layers=50, mode="ir_se",
                     emb_size=64 if size == "micro" else 512)
    gen = torch.Generator().manual_seed(11)
    init_weights(m, gen)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.running_mean.copy_(0.1 * torch.randn(
                    mod.num_features, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(
                    mod.num_features, generator=gen))
    return m.eval(), side


def export_images(side: int, n: int = 8) -> torch.Tensor:
    rng = np.random.RandomState(13)
    return torch.from_numpy(rng.uniform(-1, 1, (n, side, side, 3)).astype(
        np.float32))


def task_export(mesh, args):
    """Embeddings of 8 seeded images: through ``export_embedder_sharded``
    and ``run_sharded``; without a mesh through ``export_embedder`` on the
    whole batch."""
    from ..utils import export
    model, side = export_backbone(args.size)
    images = export_images(side).to(args.device)
    if mesh is None:
        prog = export.export_embedder(model, image_size=side,
                                      device=args.device)
        return {"emb": prog.module()(images)}
    prog = export.export_embedder_sharded(model, mesh, image_size=side,
                                          device=args.device)
    return {"emb": export.run_sharded(prog, images, mesh)}


# -- stage 3 -------------------------------------------------------------------

def stage3_setup(size: str, sync_bn: bool = False,
                 bn_groups: Optional[int] = None,
                 compute_dtype: str = "float32"):
    """(backbone, Stage3Config, image side, packed image side)."""
    from ..models.psp import PSpFaceRec
    from ..train.stage3 import Stage3Config
    micro = size == "micro"
    with micro_widths(micro):
        side = 32 if micro else 112
        backbone = PSpFaceRec(side, 50, 64 if micro else 512,
                              block_dropout=0.15)
    cfg = Stage3Config(emb_size=64 if micro else 512,
                       num_classes=64 if micro else 28000,
                       batch_size=8, stages=(1,),
                       freeze_backbone_epochs=0, compute_dtype=compute_dtype,
                       augment_crop=side, sync_bn=sync_bn,
                       bn_groups=bn_groups)
    return backbone, cfg, side, side + (4 if micro else 16)


def task_stage3(mesh, args, sync_bn: bool = False,
                compute_dtype: str = "float32"):
    """``args.steps`` steps of ``Stage3Trainer`` from packed shards through
    the rank's ``PackedLoader`` slice and ``device_prefetch``: block
    dropout 0.15, crops and flips on, ArcFace + focal, SGD. BatchNorm is
    per replica (the one-process reference: ghost BatchNorm with a group
    per data rank) or with ``sync_bn`` synchronized (the reference: whole
    batch). At micro size the backbone and head run in float64: SGD
    carries a PReLU input within f32 round-off of 0 that takes the other
    branch in one run into a second step's gradient (~5 % of a tensor's
    largest update), and float64 puts such inputs out of reach.
    ``compute_dtype="bfloat16"`` is the recipe's step: the backbone under
    bf16 autocast (on the CPU autocast leaves the float64 micro backbone
    as it is) and the cosine's operands rounded to bf16, which a model
    axis > 1 does in each class shard."""
    from ..data.packed import (PackedLoader, PackedTrainDataset,
                               device_prefetch, write_packed)
    from ..train.stage3 import Stage3Trainer
    ghost = None if mesh is not None or sync_bn else args.n_data
    backbone, cfg, side, packed_side = stage3_setup(args.size, sync_bn,
                                                    ghost, compute_dtype)
    n_data = 1 if mesh is None else mesh.shape["data"]
    index = 0 if mesh is None else mesh.data.index
    trainer = Stage3Trainer(backbone, cfg, steps_per_epoch=2,
                            device=args.device, seed=0, mesh=mesh)
    dtype = torch.float64 if args.size == "micro" else torch.float32
    trainer.backbone.to(dtype)
    trainer.head_weight.data = trainer.head_weight.data.to(dtype)
    init = {k: v.detach().clone() for k, v in trainer.named_parameters()}
    rng = np.random.RandomState(17)
    n = cfg.batch_size * args.steps
    root = os.path.join(args.out, f"packed-{args.rank}-{args.task_tag}")
    write_packed(root, rng.randint(0, 256, (n, packed_side, packed_side, 3),
                                   dtype=np.uint8),
                 rng.randint(0, cfg.num_classes, n),
                 [str(i) for i in range(cfg.num_classes)])
    loader = PackedLoader(PackedTrainDataset(root), cfg.batch_size, seed=1,
                          process_id=index, num_processes=n_data)
    losses, top1, before = [], [], _launches()
    for step, (x, y) in enumerate(device_prefetch(iter(loader),
                                                  args.device)):
        m = trainer.train_step(x.to(dtype) / 127.5 - 1.0, y, step)
        losses.append(m["loss"])
        top1.append(m["top1"])
        _log(args, "stage3", step, m["loss"])
        if step + 1 == args.steps:
            break
    launches = _minus(_launches(), before)
    sd = trainer.state_dict()
    shard = trainer.head_weight.detach().clone()
    trainer.load_state_dict(sd)        # cuts the gathered head again
    if not torch.equal(trainer.head_weight.detach(), shard):
        raise AssertionError("load_state_dict did not restore the shard")
    state = {"backbone." + k: v for k, v in sd["backbone"].items()}
    state["head.weight"] = sd["head"]["weight"]
    return {"losses": losses, "top1": top1, "init": init, "state": state,
            "launches": launches}


# -- stage 1 -------------------------------------------------------------------

def stage1_setup(size: str):
    from ..utils.config import Stage1Config
    micro = size == "micro"
    return Stage1Config(
        image_size=16 if micro else 128, z_dim=32 if micro else 512,
        w_dim=32 if micro else 512, num_mapping_layers=2 if micro else 8,
        batch_size=8, ada_start_p=0.5 if micro else 0.0,
        ada_interval=1, lazy_gradient_penalty_interval=16,
        lazy_path_penalty_interval=4)


def task_stage1(mesh, args):
    """``args.steps`` iterations of ``Stage1Trainer`` from step 0 (R1 and
    path length at step 0, the ADA tick from step 1) on seeded reals;
    per iteration the B1/B1b/B2/B2b launches."""
    from ..train.stage1 import Stage1Trainer
    cfg = stage1_setup(args.size)
    with micro_widths(args.size == "micro"):
        tr = Stage1Trainer(cfg, device=args.device, seed=0, mesh=mesh)
    init = {"g." + k: v.detach().clone() for k, v in tr.G.named_parameters()}
    init.update({"d." + k: v.detach().clone()
                 for k, v in tr.D.named_parameters()})
    rng = np.random.RandomState(19)
    s = cfg.image_size
    logs, launches, grads = [], [], []
    for step in range(args.steps):
        reals = torch.from_numpy(rng.uniform(
            -1, 1, (cfg.batch_size, s, s, 3)).astype(np.float32))
        before = _launches()
        out = tr.train_step(_rows(mesh, reals).to(args.device), step)
        launches.append(_minus(_launches(), before))
        logs.append({k: v.detach().clone() for k, v in out.items()})
        grads.append({n + k: p.grad.clone() for n, net in
                      (("g.", tr.G), ("d.", tr.D))
                      for k, p in net.named_parameters()
                      if p.grad is not None})
        _log(args, "stage1", step, out["d_loss"])
    state = {"g." + k: v for k, v in tr.G.state_dict().items()}
    state.update({"d." + k: v for k, v in tr.D.state_dict().items()})
    state.update({"g_ema." + k: v for k, v in tr.g_ema.state_dict().items()})
    return {"logs": logs, "init": init, "state": state,
            "pl_mean": tr.pl_mean, "ada_p": tr.ada_p, "launches": launches,
            "grads": grads}


# -- stage 2 and e4e ---------------------------------------------------------

def _coach(kind: str, size: str, device: str, mesh):
    """A pSp or e4e coach: micro (output 8, input and target 32, one IR
    unit a stage, 32-channel G) or full (output 256, input and target
    112); l2 + w-norm losses, f32, Ranger."""
    from ..models.e4e import E4e
    from ..models.psp import PSp
    from ..train.stage2 import Stage2Coach, Stage2Config
    from ..train.stage2_e4e import E4eCoach, E4eConfig
    micro = size == "micro"
    side = 32 if micro else 112
    base = E4e if kind == "e4e" else PSp

    class Model(base):
        def __init__(self, output_size, input_nc):
            super().__init__(output_size, input_nc, input_size=side)

    coach_cls = E4eCoach if kind == "e4e" else Stage2Coach
    Coach = type("Coach", (coach_cls,), {"model_class": Model})
    common = dict(output_size=8 if micro else 256, target_size=side,
                  l2_lambda=1.0, lpips_lambda=0.0, w_norm_lambda=0.01,
                  compute_dtype="float32")
    if kind == "e4e":
        cfg = E4eConfig(progressive_steps=(0, 1), d_reg_every=1,
                        w_pool_size=3, **common)
    else:
        cfg = Stage2Config(**common)
    with micro_widths(micro):
        coach = Coach(cfg, device=device, seed=0, mesh=mesh)
    coach.estimate_latent_avg(torch.Generator(coach.device).manual_seed(2),
                              n_latent=512)
    return coach, side


def task_coach(kind: str, mesh, args):
    coach, side = _coach(kind, args.size, args.device, mesh)
    params = dict(coach.model.encoder.named_parameters())
    if kind == "e4e":
        params.update({"disc." + k: v for k, v in
                       coach.discriminator.named_parameters()})
    init = {k: v.detach().clone() for k, v in params.items()}
    avg = coach.make_avg_image()
    noise = (torch.Generator(coach.device) if mesh is None
             else mesh.generator(3, coach.device))
    noise.manual_seed(3)
    rng = np.random.RandomState(23)
    b = 4
    losses, d_losses, launches, grads = [], [], [], []
    for step in range(args.steps):
        x = torch.from_numpy(rng.uniform(-1, 1, (b, side, side, 3)).astype(
            np.float32)).to(coach.device)
        y = torch.from_numpy(rng.uniform(-1, 1, (b, side, side, 3)).astype(
            np.float32)).to(coach.device)
        z = torch.from_numpy(rng.randn(b, 512).astype(np.float32)).to(
            coach.device)
        if kind == "e4e":
            coach.set_stage(coach.stage_for_step(step))
        before = _launches()
        loss, logs, _ = coach.train_step(_rows(mesh, x), _rows(mesh, y), avg,
                                         noise)
        launches.append(_minus(_launches(), before))
        losses.append(loss)
        _log(args, kind, step, loss)
        if kind == "e4e":
            d_losses.append(coach.train_discriminator(_rows(mesh, x), avg,
                                                      step, z=z))
            grads.append({"disc." + k: p.grad.clone() for k, p in
                          coach.discriminator.named_parameters()})
    state = {k: v.detach().clone() for k, v in params.items()}
    bufs = {k: v.clone() for k, v in coach.model.encoder.named_buffers()}
    return {"losses": losses, "d_losses": d_losses, "init": init,
            "state": state, "buffers": bufs, "launches": launches,
            "grads": grads}


def task_stage3_rate(mesh, args):
    """ms a bf16 step of the recipe's ``PSpFaceRec`` (IR-SE-50 at 112,
    block dropout 0.15, ArcFace over 28 000 classes) at 256 images a rank
    (the global batch 256 x data), uint8 128 px inputs cropped to 112: 2
    warm-up steps, then 5 timed between host syncs."""
    from ..models.psp import PSpFaceRec
    from ..train.stage3 import Stage3Config, Stage3Trainer
    per_rank, reps = 256, 5
    cfg = Stage3Config(batch_size=per_rank, stages=(1,),
                       freeze_backbone_epochs=0, augment_crop=112)
    trainer = Stage3Trainer(PSpFaceRec(112, 50, 512, block_dropout=0.15),
                            cfg, device=args.device, seed=0, mesh=mesh)
    gen = torch.Generator().manual_seed(29 + args.rank)
    x = torch.randint(0, 256, (per_rank, 128, 128, 3), generator=gen,
                      dtype=torch.uint8).to(args.device)
    y = torch.randint(0, cfg.num_classes, (per_rank,), generator=gen).to(
        args.device)
    for i in range(2):
        trainer.train_step(x, y, i)
    torch.cuda.synchronize(args.device)
    t0 = time.perf_counter()
    for i in range(reps):
        m = trainer.train_step(x, y, i + 2)
    torch.cuda.synchronize(args.device)
    ms = (time.perf_counter() - t0) / reps * 1e3
    return {"ms": ms, "loss": m["loss"], "images_per_s":
            per_rank * (1 if mesh is None else mesh.world.size) / ms * 1e3}


# -- spatially sharded synthesis -------------------------------------------

# (name, family, resolution, batch, dtype, noise, min_rows_per_shard) of
# each run: full size at the published widths (the ADA G at 1024 with
# channel_base 16384 and channel_max 512, the rosinality G in config-f,
# the StyleGAN1-layer ADA G at 256); micro at the JAX package's test sizes
# (z/w 32, 2 mapping layers, 64 px; the rosinality G with channel
# multiplier 1), with runs whose 4x4 and 8x8 stay replicated
SPATIAL_RUNS = {
    "full": (("ada_f32_const", "ada", 1024, 4, "float32", "const", 1),
             ("ada_f32_random", "ada", 1024, 4, "float32", "random", 1),
             ("ada_bf16_const", "ada", 1024, 4, "bfloat16", "const", 1),
             ("ada_bf16_random", "ada", 1024, 4, "bfloat16", "random", 1),
             ("rosi_f32_const", "rosinality", 1024, 2, "float32", "const",
              1),
             ("rosi_f32_random", "rosinality", 1024, 2, "float32",
              "random", 1),
             ("sg1_f32_const", "stylegan1", 256, 8, "float32", "const", 1)),
    "micro": (("ada_f32_const", "ada", 64, 2, "float32", "const", 1),
              ("ada_f32_const_min4", "ada", 64, 2, "float32", "const", 4),
              ("ada_f32_random", "ada", 64, 2, "float32", "random", 1),
              ("sg1_f32_const", "stylegan1", 64, 2, "float32", "const", 1),
              ("rosi_f32_const", "rosinality", 64, 2, "float32", "const",
               1),
              ("rosi_f32_const_min4", "rosinality", 64, 2, "float32",
               "const", 4),
              ("rosi_f32_random", "rosinality", 64, 2, "float32", "random",
               1))}
# the runs of scripts/ddp_cards.py over one rank a card: the ADA and the
# rosinality G at 1024 (const noise), batch 1 and 4
SPATIAL_CARD_RUNS = tuple(
    (f"{tag}_f32_batch{b}", family, 1024, b, "float32", "const", 1)
    for tag, family in (("ada", "ada"), ("rosi", "rosinality"))
    for b in (1, 4))
SPATIAL_REPS = 3        # timed calls a run on a card (none on the CPU)


def spatial_model(family: str, resolution: int, size: str):
    """A generator of ``family`` ("ada", "stylegan1" or "rosinality"),
    weights from seed 0 drawn on the CPU, then every bias, noise strength
    and noise weight outside the mapping/style layers (zeros at init)
    moved by 0.1 N(0, 1) from seed 1, so their paths count; eval mode."""
    from ..models import stylegan2, stylegan2_ada
    from ..nn.initializers import init_weights
    dim, mlp = (32, 2) if size == "micro" else (512, 8)
    if family == "rosinality":
        g = stylegan2.Generator(resolution, dim, mlp,
                                1 if size == "micro" else 2)
    else:
        g = stylegan2_ada.Generator(
            dim, dim, mlp, resolution, synthesis_layer="stylegan1"
            if family == "stylegan1" else "stylegan2")
    init_weights(g, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for mod in g.modules():
            if isinstance(mod, (stylegan2.EqualLinear,
                                stylegan2_ada.FullyConnectedLayer)):
                continue
            for k, p in mod.named_parameters(recurse=False):
                if k in ("bias", "noise_strength") or isinstance(
                        mod, stylegan2.NoiseInjection):
                    p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return g.eval()


def spatial_inputs(batch: int, size: str) -> np.ndarray:
    """z (batch, z_dim) from seed 31."""
    dim = 32 if size == "micro" else 512
    return np.random.RandomState(31).randn(batch, dim).astype(np.float32)


def spatial_kwargs(family: str, noise: str) -> dict:
    if family == "rosinality":
        return {"randomize_noise": noise == "random"}
    return {"noise_mode": noise}


def task_spatial(mesh, args, runs=None):
    """Every run of ``runs`` (default ``SPATIAL_RUNS[args.size]``): with a
    mesh, the rank's band through ``make_spatial_synthesis`` over the data
    axis, its rows, the bands each block's output had and whether
    ``gather_rows`` gives an image holding the band; without, one
    process's whole image. Each with its B1/B1b/B2/B2b launches (of the first call) and,
    on a card, ms a call (the median of ``SPATIAL_REPS`` after it) and the
    peak GiB above the weights. Random noise comes from a generator
    seeded 7 on the run's device."""
    from .spatial import gather_rows, make_spatial_synthesis
    out, model, key = {}, None, None
    cuda = torch.device(args.device).type == "cuda"
    for name, family, res, batch, dtype, noise, min_rows in \
            runs or SPATIAL_RUNS[args.size]:
        if key != (family, res):
            model = None
            _release()
            model = spatial_model(family, res, args.size).to(args.device)
            key = (family, res)
        model.to(getattr(torch, dtype))
        z = torch.from_numpy(spatial_inputs(batch, args.size)).to(
            args.device, getattr(torch, dtype))
        kw = spatial_kwargs(family, noise)
        if mesh is None:
            def run(gen):
                with torch.no_grad():
                    return model(z, generator=gen, **kw)
        else:
            synth = make_spatial_synthesis(model, mesh, "data", min_rows,
                                           **kw)

            def run(gen):
                return synth(z, gen)
        if cuda:
            torch.cuda.synchronize(args.device)
            torch.cuda.reset_peak_memory_stats(args.device)
            base = torch.cuda.memory_allocated(args.device)
        before = _launches()
        img = run(torch.Generator(args.device).manual_seed(7))
        launches = _minus(_launches(), before)
        r = {"image": img, "launches": launches, "ms": None,
             "peak_gib": None, "dtype": dtype}
        if cuda:
            torch.cuda.synchronize(args.device)
            r["peak_gib"] = (torch.cuda.max_memory_allocated(args.device)
                             - base) / 2 ** 30
            ms = []
            for _ in range(SPATIAL_REPS):
                gen = torch.Generator(args.device).manual_seed(7)
                torch.cuda.synchronize(args.device)
                t0 = time.perf_counter()
                run(gen)
                torch.cuda.synchronize(args.device)
                ms.append((time.perf_counter() - t0) * 1e3)
            r["ms"] = float(np.median(ms))
        if mesh is not None:
            lo, hi = synth.policy.rows(img.shape[2] * mesh.data.size)
            whole = gather_rows(img, mesh)
            r.update(rows=(lo, hi), bands=list(synth.bands),
                     gather_ok=whole.shape[2] == img.shape[2]
                     * mesh.data.size
                     and torch.equal(whole[:, :, lo:hi], img))
        out[name] = r
    return out


TASKS = {"head": task_head, "bn": task_bn, "export": task_export,
         "stage3": task_stage3, "stage3_rate": task_stage3_rate,
         "stage3_sync": lambda mesh, args: task_stage3(mesh, args, True),
         "stage3_bf16": lambda mesh, args: task_stage3(
             mesh, args, compute_dtype="bfloat16"),
         "stage1": task_stage1, "spatial": task_spatial,
         "spatial_cards": lambda mesh, args: task_spatial(
             mesh, args, SPATIAL_CARD_RUNS),
         "stage2": lambda mesh, args: task_coach("stage2", mesh, args),
         "e4e": lambda mesh, args: task_coach("e4e", mesh, args)}


def run_task(name: str, mesh, size: str = "micro", device: str = "cuda",
             steps: int = 2, out: Optional[str] = None, rank: int = 0,
             n_data: int = 2, tag: Optional[str] = None):
    """One task's results, moved to the CPU, for ``mesh``, or for one
    process on the whole global batch when ``mesh`` is None. ``n_data``
    is the data size the one-process BatchNorm reference emulates."""
    with tempfile.TemporaryDirectory() as tmp:
        args = argparse.Namespace(size=size, device=device, steps=steps,
                                  out=out or tmp, rank=rank,
                                  task_tag=tag or name, n_data=n_data)
        return _cpu(TASKS[name](mesh, args))


# -- comparison ----------------------------------------------------------------

def _losses(res) -> List[torch.Tensor]:
    if "logs" in res:
        return [torch.stack([r["d_loss"], r["g_loss"], r["plp"]])
                for r in res["logs"]]
    return list(res["losses"]) + list(res.get("d_losses", []))


def compare(got: dict, want: dict, loss_rtol: float, rel: float,
            adam_floor: float = 1e-6, adam_rel: float = 0.0) -> List[str]:
    """What of a rank's results ``got`` disagrees with the one-process
    ``want`` (the weights start from the same seed, so ``want["init"]``
    is the rank's start too): losses beyond ``loss_rtol`` relative; each
    step's recorded gradients beyond ``rel`` of the tensor's largest; each
    parameter's update since the start beyond ``rel`` of the tensor's
    largest update plus 1e-6 of any tensor's largest and 4 ulps of the
    parameter. Where
    gradients are recorded (Adam), updates are held only where every
    step's reference gradient is above ``adam_floor`` and ``adam_rel`` of
    the tensor's largest: Adam's first step is about -lr sign(g), so a
    gradient within its round-off of 0 (or near eps) can move by up to
    the learning rate. The CPU holds 1e-6 (100x eps); the card, whose two
    batch sizes take different convolution algorithms, phase 16's 1e-4
    (1e4 eps) and 1e-3 of the largest."""
    bad = []
    for i, (a, b) in enumerate(zip(_losses(got), _losses(want))):
        if not torch.allclose(a.double(), b.double(), rtol=loss_rtol,
                              atol=0):
            bad.append(f"loss {i}: {a.tolist()} vs {b.tolist()}")
    for i, (gs, ws) in enumerate(zip(got.get("grads", []),
                                     want.get("grads", []))):
        for k, w in ws.items():
            err = float((gs[k] - w).abs().max())
            if err > rel * float(w.abs().max()):
                bad.append(f"step {i} gradient {k}: {err:.3g}")
    if "state" not in got:           # a rank other than 0: its digest
        return bad
    upd = {k: want["state"][k] - want["init"][k] for k in want["init"]}
    top = max(float(u.abs().max()) for u in upd.values())
    for k, u in upd.items():
        p = want["state"][k]
        tol = (rel * u.abs().max() + 1e-6 * top
               + 4 * torch.finfo(p.dtype).eps * p.abs())
        off = (got["state"][k] - want["init"][k] - u).abs() > tol
        grads = [g[k] for g in want.get("grads", []) if k in g]
        if grads:
            off &= torch.stack([
                g.abs() > max(adam_floor, adam_rel * float(g.abs().max()))
                for g in grads]).all(0)
        if off.any():
            bad.append(f"update {k}: {int(off.sum())} elements")
    for k in ("pl_mean", "ada_p"):
        if k in want and not torch.allclose(got[k], want[k], rtol=loss_rtol):
            bad.append(f"{k}: {float(got[k])} vs {float(want[k])}")
    return bad


# -- processes -----------------------------------------------------------------

def spawn(tasks: Sequence[str], world: int, out: str, device: str = "cuda",
          size: str = "micro", backend: Optional[str] = None, steps: int = 2,
          tol: Sequence[float] = (1e-5, 2e-3, 1e-6, 0.0),
          timeout: float = 600.0) -> List[dict]:
    """Run ``tasks`` in ``world`` worker processes joined through a
    ``file://`` rendezvous in ``out``; returns each rank's results. A
    trainer task's results are its losses, launches and ``digest``, and on
    rank 0 ``bad``, what ``compare(..., *tol)`` found against one process
    on the whole batch, with that process's ``launches_one_process``. A
    failed or timed-out rank raises with the ranks' output."""
    os.makedirs(out, exist_ok=True)
    init = "file://" + os.path.join(out, f"init-{time.time_ns()}")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "stylegan_for_facerec_torch.parallel."
           "_mp_worker", "--world", str(world), "--init", init, "--out", out,
           "--device", device, "--size", size, "--steps", str(steps),
           "--tol", *(str(t) for t in tol), "--tasks", *tasks]
    if backend:
        cmd += ["--backend", backend]
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f.read())
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("worker ranks failed (" + ", ".join(
            str(p.returncode) for p in procs) + "):\n" + "\n".join(
            f"--- rank {r} ---\n{t[-4000:]}" for r, t in enumerate(text)))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _release():
    """Hand the freed memory of a finished run back to the system (the
    worker runs beside other processes)."""
    gc.collect()
    if sys.platform.startswith("linux"):
        ctypes.CDLL("libc.so.6").malloc_trim(0)


def _checked(res: dict, name: str, n_data: int, args) -> dict:
    """A trainer task's small results: its losses, launches and a digest
    of its end state and gradients (equal on every rank); rank 0 also
    steps one process on the whole batch and keeps what ``compare`` finds
    (``bad``) and that process's launches."""
    keep = ("losses", "logs", "d_losses", "launches", "pl_mean", "ada_p",
            "seconds")
    out = {k: res[k] for k in keep if k in res}
    grads = {f"{i}:{k}": g for i, step in enumerate(res.get("grads", []))
             for k, g in step.items()}
    out["digest"] = digest({**res["state"], **res.get("buffers", {}),
                            **grads})
    if args.rank == 0:
        want = run_task(name, None, args.size, args.device, args.steps,
                        args.out, n_data=n_data, tag=f"{name}_{n_data}_one")
        out["bad"] = compare(res, want, *args.tol)
        out["launches_one_process"] = want["launches"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tasks", nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", default="micro", choices=("micro", "full"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--tol", type=float, nargs=4,
                    default=(1e-5, 2e-3, 1e-6, 0.0),
                    metavar=("LOSS_RTOL", "REL", "ADAM_FLOOR", "ADAM_REL"),
                    help="compare's tolerances for the trainer tasks")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .mesh import initialize_distributed, make_mesh
    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        if args.device == "cuda":       # one card a rank
            torch.cuda.set_device(args.rank % torch.cuda.device_count())
            args.device = f"cuda:{torch.cuda.current_device()}"
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    initialize_distributed(args.init, args.world, args.rank, args.backend)
    print(f"[mp{args.rank}] {args.world} processes, backend "
          f"{dist.get_backend()}, device {args.device}", flush=True)
    results = {}
    for spec in args.tasks:
        name, _, layout = spec.partition(":")
        data, model = (int(v) for v in (layout or f"{args.world}x1").split(
            "x"))
        mesh = make_mesh(data, model, device=args.device)
        t0 = time.perf_counter()
        res = run_task(name, mesh, args.size, args.device, args.steps,
                       args.out, args.rank, tag=spec.replace(":", "_"))
        res["seconds"] = time.perf_counter() - t0
        results[spec] = _checked(res, name, data, args) \
            if "state" in res else res
        del res
        _release()
    torch.save(results, os.path.join(args.out, f"rank{args.rank}.pt"))
    dist.destroy_process_group()
    print("MP_WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.exit(main())
