"""Stage-3 face-recognition trainer, as
``stylegan_for_facerec_tpu/train/stage3.py``, on one GPU or data- and
class-parallel over the ranks of a ``parallel.mesh.Mesh``.

  * The backbone (``PSpFaceRec``, an IR ``Backbone``, a ``ResNet`` or a
    ``MobileFaceNet``) maps NHWC images in [-1, 1] (or uint8, mapped by
    x / 127.5 - 1) to embeddings; the trainer owns the class weight
    ``head_weight`` (C, D). The margin (ArcFace, CosFace or plain
    softmax, ``parallel.sharded_head.margin_logits``) runs in float32
    (float64 for a float64 backbone, as a float64 reference step has) on
    the cosine of the L2-normalized features and class weights, and the
    loss (focal or CE) in float32: one process runs ``local_margin_ce``
    over a ``LocalAxis``, whose collectives are the identity.
  * ``torch.optim.SGD`` with momentum, weight decay on every parameter but
    BatchNorm's, and the learning rate of ``Stage3Schedule`` at the
    optimizer's own step count (``opt_count``, saved with the checkpoint),
    as optax's schedule reads its state's count.
  * ``freeze_mask(True)`` freezes the encoder body: ``train_step`` takes
    frozen parameters out of autograd, so they get no gradient, no decay
    and no momentum change; the body's BatchNorm still updates its running
    statistics, since it stays in train mode.
  * ``compute_dtype="bfloat16"`` runs the backbone under ``torch.autocast``:
    parameters, momentum and BatchNorm statistics stay float32. The
    cosine's operands are rounded to bf16 and their product is accumulated
    and returned in float32 (the JAX package's bf16 dot with
    ``preferred_element_type=float32``).
  * ``bn_groups`` sets ghost BatchNorm on every BatchNorm of the backbone
    (None: whole-batch statistics, the one-GPU default).
  * Dropout masks, crop offsets and flips draw from ``generator``, a
    ``torch.Generator`` on the trainer's device seeded from ``seed``.
  * ``remat`` runs the backbone's forward under
    ``torch.utils.checkpoint`` (non-reentrant): its activations are
    recomputed in the backward pass instead of kept. The recomputation
    draws the forward's dropout masks again (the generator's state is
    replayed) and does not move BatchNorm's running statistics a second
    time, so the step is the one without remat.

With ``mesh`` (data axis ``d``, model axis ``m``) each rank steps its
slice of the global batch, and the step equals one process's step on the
concatenated batch:

  * the backbone is replicated; its gradients are summed over the data
    axis in one flattened all-reduce (the loss is the global batch's
    mean, whose backward gives each rank its own rows' share), with m > 1
    over every rank and divided by m, so the model axis's replicas stay
    bit-equal where the card's backward is not reproducible;
  * the head weight is the rank's class shard ``(C / m, D)`` outside that
    sum's world: its gradient is summed over the data axis only. With
    m > 1 the margin and the softmax run through
    ``parallel.sharded_head``;
  * the focal transform is applied to the global mean cross-entropy;
  * BatchNorm is per replica by default (each rank's batch normalised
    alone, rank 0's (data index 0's) running statistics broadcast to
    every rank after each step:
    DDP's ``broadcast_buffers``, JAX's ``bn_groups`` = data size), or with
    ``sync_bn`` synchronized over the data axis (the statistics are then
    the global batch's on every rank, and nothing is broadcast);
  * dropout masks, crop offsets and flips are drawn for the global batch
    from the trainer's seeded ``SliceGenerator``; the rank keeps its rows;
  * ``state_dict`` gathers the head shards into the one-GPU layout (a
    collective: every rank calls it) and ``load_state_dict`` cuts them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.dataset import device_augment
from ..losses.focal import focal_of_mean
from ..nn.initializers import init_weights, xavier_uniform_
from ..nn.layers import Dropout, _GhostBatchNorm
from ..parallel.mesh import LocalAxis
from ..parallel.sharded_head import local_margin_ce, topk_correct
from ..utils.device import resolve_device
from ..utils.tracing import count, span
from . import optim

FROZEN_PREFIXES = ("backbone.body", "backbone.encoder.body")


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    """The JAX package's ``Stage3Config``. ``sync_bn`` synchronizes
    BatchNorm over a mesh's data axis; ``bn_groups`` counts ghost groups
    in the global batch (per rank: ``bn_groups // data``)."""

    emb_size: int = 512
    num_classes: int = 28000
    head: str = "ArcFace"
    loss: str = "Focal"
    arcface_s: float = 64.0
    margin: float = 0.50
    lr: float = 0.03
    momentum: float = 0.9
    weight_decay: float = 2e-3
    batch_size: int = 100
    num_epochs: int = 100
    stages: Sequence[int] = tuple(range(15, 130, 5))
    warmup_batches: int = 0
    freeze_backbone_epochs: int = 3
    sync_bn: bool = False
    bn_groups: Optional[int] = None
    compute_dtype: str = "bfloat16"
    remat: bool = False
    augment_crop: Optional[int] = None


@contextlib.contextmanager
def _as_in_forward(generator: torch.Generator, state: torch.Tensor,
                   batchnorms):
    """A recomputation's context: ``generator`` at ``state`` (the forward's
    start, so dropout draws the same masks), and ``batchnorms`` at
    momentum 0, so their running statistics stay as the forward left
    them (running * 1 + batch * 0); the momenta, the generator and
    ``num_batches_tracked`` restored after. The recomputation saves the
    same tensors for the backward as the forward did."""
    after = generator.get_state()
    generator.set_state(state)
    saved = [(m, m.momentum, m.num_batches_tracked.clone()) for m in
             batchnorms]
    for m in batchnorms:
        m.momentum = 0.0
    try:
        yield
    finally:
        generator.set_state(after)
        for m, momentum, tracked in saved:
            m.momentum = momentum
            m.num_batches_tracked.copy_(tracked)


class Stage3Trainer:
    """Owns ``backbone`` (moved to ``device``, train mode), ``head_weight``
    and the SGD optimizer. The weights are drawn from ``seed`` on the CPU
    (``init``), so a seed gives the same weights on every device and
    rank. ``mesh`` makes the step data- and class-parallel."""

    _HEADS = {"ArcFace": "arcface", "CosFace": "cosface",
              "Softmax": "softmax"}

    def __init__(self, backbone: nn.Module, cfg: Stage3Config,
                 steps_per_epoch: int = 1000, device: str = "cuda",
                 seed: int = 0, mesh=None):
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: "
                             f"float32|bfloat16")
        if cfg.head not in ("ArcFace", "CosFace", "Softmax"):
            raise ValueError(f"head {cfg.head!r}: ArcFace|CosFace|Softmax")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backbone = backbone
        self.mesh = mesh
        n_data = 1 if mesh is None else mesh.shape["data"]
        n_model = 1 if mesh is None else mesh.shape["model"]
        if cfg.bn_groups is not None and cfg.bn_groups % n_data:
            raise ValueError(f"bn_groups {cfg.bn_groups} does not split "
                             f"over the {n_data} data ranks")
        if cfg.num_classes % n_model:
            raise ValueError(f"{cfg.num_classes} classes do not split over "
                             f"{n_model} model ranks")
        self.bn_groups = (None if cfg.bn_groups is None
                          else cfg.bn_groups // n_data)
        for m in backbone.modules():
            if isinstance(m, _GhostBatchNorm):
                m.bn_groups = self.bn_groups
                if mesh is not None and cfg.sync_bn:
                    m.sync = mesh.data
        self.generator = (torch.Generator(self.device) if mesh is None
                          else mesh.generator(seed, self.device))
        for m in backbone.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self._batchnorms = [m for m in backbone.modules() if isinstance(
            m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]
        # the BatchNorms whose running statistics are rank 0's by broadcast
        self._per_replica = [m for m in self._batchnorms
                             if getattr(m, "sync", None) is None]
        self.schedule = optim.Stage3Schedule(
            base_lr=cfg.lr, warmup_batches=cfg.warmup_batches,
            steps_per_epoch=steps_per_epoch, stages=tuple(cfg.stages))
        self.head_weight = nn.Parameter(torch.empty(
            cfg.num_classes // n_model, cfg.emb_size))
        # the axis the head's classes are split over
        self._class_axis = mesh.model if n_model > 1 else LocalAxis()
        self.init(seed)

    # -- params ------------------------------------------------------------

    def named_parameters(self):
        yield from (("backbone." + k, p)
                    for k, p in self.backbone.named_parameters())
        yield "head.weight", self.head_weight

    def init(self, seed: int = 0):
        """Draw the backbone's and the head's weights from ``seed``, reset
        the optimizer (count 0) and seed ``generator`` with ``seed``. Its
        host seconds add to the counter ``sgfr.setup.weight_init_s``."""
        t0 = time.perf_counter()
        gen = torch.Generator().manual_seed(seed)
        init_weights(self.backbone.cpu(), gen)
        self.backbone.to(self.device).train()
        with torch.no_grad():
            w = torch.empty(self.cfg.num_classes, self.cfg.emb_size)
            xavier_uniform_(w, gen)
            self.head_weight.data = self._class_rows(w).to(self.device)
        decay = optim.batchnorm_decay_mask(self.backbone)
        decay = {"backbone." + k: v for k, v in decay.items()}
        decay["head.weight"] = True
        self.optimizer = torch.optim.SGD(
            optim.sgd_param_groups(self.named_parameters(), decay,
                                   self.cfg.weight_decay),
            lr=self.cfg.lr, momentum=self.cfg.momentum, nesterov=False)
        self.opt_count = 0
        self.generator.manual_seed(seed)
        count("sgfr.setup.weight_init_s", time.perf_counter() - t0)

    def _class_rows(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a (num_classes, ...) tensor."""
        if self.mesh is None:
            return w
        return w[self.mesh.model.rows(w.shape[0])]

    def freeze_mask(self, frozen: bool) -> Dict[str, bool]:
        """{parameter name: trains}; with ``frozen`` the encoder body
        (``backbone.body`` of a Backbone, ``backbone.encoder.body`` of a
        PSpFaceRec) does not train; the input layer, output layer and head
        do. A backbone without a ``body`` (``ResNet``, ``MobileFaceNet``)
        trains whole, as in the JAX package."""
        names = [k for k, _ in self.named_parameters()]
        return optim.freeze_mask_for(names, FROZEN_PREFIXES if frozen
                                     else ())

    # -- math --------------------------------------------------------------

    def _loss(self, images: torch.Tensor, labels: torch.Tensor):
        if images.dtype == torch.uint8:
            images = images.float() / 127.5 - 1.0
        x = images.permute(0, 3, 1, 2)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.compute_dtype == "bfloat16"):
            if self.cfg.remat:
                features = checkpoint(self.backbone, x, use_reentrant=False,
                                      context_fn=self._remat_contexts)
            else:
                features = self.backbone(x)
        # float32 (float64 for a float64 backbone)
        features = features.to(torch.promote_types(features.dtype,
                                                   torch.float32))
        axis = self._class_axis
        ce, hits, logits = local_margin_ce(
            features, self.head_weight, labels, axis,
            kind=self._HEADS[self.cfg.head], s=self.cfg.arcface_s,
            m=self.cfg.margin,
            bf16_operands=self.cfg.compute_dtype == "bfloat16")
        top1 = hits.mean()
        top5 = topk_correct(logits, labels, axis, 5).mean()
        mean_ce = torch.mean(ce)
        if self.mesh is not None:
            mean_ce = self.mesh.data.mean_share(mean_ce)
            top1, top5 = self.mesh.data.mean(top1), self.mesh.data.mean(top5)
        loss = focal_of_mean(mean_ce) if self.cfg.loss == "Focal" \
            else mean_ce
        return loss, top1, top5

    def _remat_contexts(self):
        """(forward, recomputation) contexts of one checkpointed forward."""
        return contextlib.nullcontext(), _as_in_forward(
            self.generator, self.generator.get_state(), self._batchnorms)

    def _sync_grads(self):
        """The head shard's gradient summed over the data axis; the
        backbone's too, and with m > 1 over every rank and divided by m:
        the model axis's replicas compute the same gradient, but a GPU's
        backward need not be bit-reproducible, and replicas must stay
        equal."""
        body = list(self.backbone.parameters())
        n_model = self.mesh.shape["model"]
        if n_model == 1:
            self.mesh.data.sum_grads_(body + [self.head_weight])
            return
        self.mesh.data.sum_grads_([self.head_weight])
        self.mesh.world.sum_grads_(body)
        for p in body:
            if p.grad is not None:
                p.grad.div_(n_model)

    # -- public ------------------------------------------------------------

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   step: int, grad_mask: Optional[Dict[str, bool]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One SGD step on (B, H, W, 3) images (float in [-1, 1] or uint8)
        and (B,) labels on the trainer's device. ``grad_mask`` (from
        ``freeze_mask``) says which parameters train. Returns the step's
        metrics: loss, top1, top5 as device tensors, and lr, the schedule
        at ``step``. Spans (``utils/tracing.py``): ``sgfr.stage3.step``
        around ``augment`` (with ``augment_crop``), ``forward``,
        ``backward``, ``grad_sync`` (under a mesh), ``optimizer`` and
        ``bn_broadcast`` (under a mesh with per-replica BatchNorm)."""
        with span("sgfr.stage3.step"):
            return self._train_step(images, labels, step, grad_mask)

    def _train_step(self, images, labels, step, grad_mask):
        for k, p in self.named_parameters():
            p.requires_grad_(True if grad_mask is None else grad_mask[k])
        self.backbone.train()
        if self.cfg.augment_crop is not None:
            with span("sgfr.stage3.augment"):
                images = device_augment(images, self.generator,
                                        self.cfg.augment_crop)
        self.optimizer.zero_grad(set_to_none=True)
        with span("sgfr.stage3.forward"):
            loss, top1, top5 = self._loss(images, labels)
        with span("sgfr.stage3.backward"):
            loss.backward()
        if self.mesh is not None:
            with span("sgfr.stage3.grad_sync"):
                self._sync_grads()
        with span("sgfr.stage3.optimizer"):
            lr = self.schedule(self.opt_count)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
            self.opt_count += 1
        if self.mesh is not None and self._per_replica:
            with span("sgfr.stage3.bn_broadcast"):
                self.mesh.world.broadcast_(
                    b for m in self._per_replica for b in m.buffers())
        return {"loss": loss.detach(), "top1": top1.detach(),
                "top5": top5.detach(), "lr": self.schedule(step)}

    @torch.no_grad()
    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Embeddings of NHWC images in [-1, 1], BatchNorm in eval mode,
        in the trainer's compute dtype; the backbone is left in train
        mode."""
        self.backbone.eval()
        try:
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=self.cfg.compute_dtype == "bfloat16"):
                return self.backbone(images.permute(0, 3, 1, 2)).float()
        finally:
            self.backbone.train()

    # -- checkpoints -------------------------------------------------------

    def _head_index(self) -> int:
        """The head weight's index in the optimizer's state_dict."""
        params = [p for g in self.optimizer.param_groups
                  for p in g["params"]]
        return next(i for i, p in enumerate(params)
                    if p is self.head_weight)

    def _gather_classes(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or self.mesh.shape["model"] == 1:
            return t
        return self.mesh.model.gather(t)

    def state_dict(self) -> Dict:
        """The stage-3 checkpoint payload, as copies on the CPU: the
        backbone's state_dict (``avg_image`` included where the backbone
        has one, and also as (H, W, 3) under ``avg_image``), the head
        weight, the SGD state and the schedule's step count. Under a mesh
        the head weight and its momentum are gathered into the one-GPU
        layout: every rank must call it."""
        opt = self.optimizer.state_dict()
        head = self._head_index()
        opt["state"] = {i: {k: (self._gather_classes(v) if i == head
                                and torch.is_tensor(v) and v.ndim == 2
                                else v).to("cpu", copy=True)
                            if torch.is_tensor(v) else v
                            for k, v in st.items()}
                        for i, st in opt["state"].items()}
        avg = getattr(self.backbone, "avg_image", None)
        return {"backbone": {k: v.cpu() for k, v in
                             self.backbone.state_dict().items()},
                "head": {"weight": self._gather_classes(
                    self.head_weight.detach()).cpu()},
                "optimizer": opt, "opt_count": self.opt_count,
                "avg_image": None if avg is None
                else avg.permute(1, 2, 0).cpu()}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.backbone.load_state_dict(ckpt["backbone"], strict=True)
        with torch.no_grad():
            self.head_weight.copy_(self._class_rows(ckpt["head"]["weight"]))
        opt = ckpt["optimizer"]
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            head = self._head_index()
            opt = dict(opt, state={i: {k: self._class_rows(v) if i == head
                                       and torch.is_tensor(v) and v.ndim == 2
                                       else v for k, v in st.items()}
                                   for i, st in opt["state"].items()})
        self.optimizer.load_state_dict(opt)
        self.opt_count = int(ckpt["opt_count"])
