"""Stage-3 face-recognition trainer on one GPU, as
``stylegan_for_facerec_tpu/train/stage3.py`` without its mesh.

  * The backbone (``PSpFaceRec``, an IR ``Backbone``, a ``ResNet`` or a
    ``MobileFaceNet``) maps NHWC images in [-1, 1] (or uint8, mapped by
    x / 127.5 - 1) to embeddings; the trainer owns the class weight
    ``head_weight`` (C, D). The margin (ArcFace, CosFace or plain
    softmax) and the loss (focal or CE) run in float32 (float64 for a
    float64 backbone, as a float64 reference step has) on the cosine of
    the L2-normalized features and class weights.
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
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..losses.focal import focal_loss, softmax_cross_entropy, topk_accuracy
from ..models.heads import arcface_margin, cosface_margin
from ..nn.initializers import init_weights, xavier_uniform_
from ..nn.layers import Dropout, _GhostBatchNorm
from ..ops.image import random_crop, random_hflip
from ..utils.device import resolve_device
from . import optim

FROZEN_PREFIXES = ("backbone.body", "backbone.encoder.body")


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    """The JAX package's ``Stage3Config`` without the mesh's
    ``sync_bn``."""

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
    (``init``), so a seed gives the same weights on every device."""

    def __init__(self, backbone: nn.Module, cfg: Stage3Config,
                 steps_per_epoch: int = 1000, device: str = "cuda",
                 seed: int = 0):
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: "
                             f"float32|bfloat16")
        if cfg.head not in ("ArcFace", "CosFace", "Softmax"):
            raise ValueError(f"head {cfg.head!r}: ArcFace|CosFace|Softmax")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backbone = backbone
        self.bn_groups = cfg.bn_groups
        for m in backbone.modules():
            if isinstance(m, _GhostBatchNorm):
                m.bn_groups = cfg.bn_groups
        self.generator = torch.Generator(self.device)
        for m in backbone.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        self._batchnorms = [m for m in backbone.modules() if isinstance(
            m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats]
        self.schedule = optim.Stage3Schedule(
            base_lr=cfg.lr, warmup_batches=cfg.warmup_batches,
            steps_per_epoch=steps_per_epoch, stages=tuple(cfg.stages))
        self.head_weight = nn.Parameter(torch.empty(cfg.num_classes,
                                                    cfg.emb_size))
        self.init(seed)

    # -- params ------------------------------------------------------------

    def named_parameters(self):
        yield from (("backbone." + k, p)
                    for k, p in self.backbone.named_parameters())
        yield "head.weight", self.head_weight

    def init(self, seed: int = 0):
        """Draw the backbone's and the head's weights from ``seed``, reset
        the optimizer (count 0) and seed ``generator`` with ``seed``."""
        gen = torch.Generator().manual_seed(seed)
        init_weights(self.backbone.cpu(), gen)
        self.backbone.to(self.device).train()
        with torch.no_grad():
            w = torch.empty(self.cfg.num_classes, self.cfg.emb_size)
            xavier_uniform_(w, gen)
            self.head_weight.data = w.to(self.device)
        decay = optim.batchnorm_decay_mask(self.backbone)
        decay = {"backbone." + k: v for k, v in decay.items()}
        decay["head.weight"] = True
        self.optimizer = torch.optim.SGD(
            optim.sgd_param_groups(self.named_parameters(), decay,
                                   self.cfg.weight_decay),
            lr=self.cfg.lr, momentum=self.cfg.momentum, nesterov=False)
        self.opt_count = 0
        self.generator.manual_seed(seed)

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

    def _margin_logits(self, features: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        f = features / torch.clamp(
            torch.linalg.norm(features, dim=-1, keepdim=True), min=1e-12)
        w = self.head_weight / torch.clamp(
            torch.linalg.norm(self.head_weight, dim=-1, keepdim=True),
            min=1e-12)
        if cfg.compute_dtype == "bfloat16":
            # bf16 operands, exact products summed in float32
            f = f.to(torch.bfloat16).float()
            w = w.to(torch.bfloat16).float()
        cosine = f @ w.t()
        if cfg.head == "Softmax":
            return cosine * cfg.arcface_s
        one_hot = F.one_hot(labels.long(), cfg.num_classes).to(cosine.dtype)
        if cfg.head == "ArcFace":
            return arcface_margin(cosine, one_hot, cfg.arcface_s, cfg.margin)
        return cosface_margin(cosine, one_hot, cfg.arcface_s, cfg.margin)

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
        logits = self._margin_logits(features, labels)
        if self.cfg.loss == "Focal":
            loss = focal_loss(logits, labels)
        else:
            loss = softmax_cross_entropy(logits, labels)
        return loss, logits.detach()

    def _remat_contexts(self):
        """(forward, recomputation) contexts of one checkpointed forward."""
        return contextlib.nullcontext(), _as_in_forward(
            self.generator, self.generator.get_state(), self._batchnorms)

    # -- public ------------------------------------------------------------

    def train_step(self, images: torch.Tensor, labels: torch.Tensor,
                   step: int, grad_mask: Optional[Dict[str, bool]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One SGD step on (B, H, W, 3) images (float in [-1, 1] or uint8)
        and (B,) labels on the trainer's device. ``grad_mask`` (from
        ``freeze_mask``) says which parameters train. Returns the step's
        metrics: loss, top1, top5 as device tensors, and lr, the schedule
        at ``step``."""
        for k, p in self.named_parameters():
            p.requires_grad_(True if grad_mask is None else grad_mask[k])
        self.backbone.train()
        if self.cfg.augment_crop is not None:
            images = random_crop(images, self.cfg.augment_crop,
                                 self.generator)
            images = random_hflip(images, self.generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self._loss(images, labels)
        loss.backward()
        lr = self.schedule(self.opt_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.opt_count += 1
        return {"loss": loss.detach(),
                "top1": topk_accuracy(logits, labels, 1),
                "top5": topk_accuracy(logits, labels, 5),
                "lr": self.schedule(step)}

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

    def state_dict(self) -> Dict:
        """The stage-3 checkpoint payload, as copies on the CPU: the
        backbone's state_dict (``avg_image`` included where the backbone
        has one, and also as (H, W, 3) under ``avg_image``), the head
        weight, the SGD state and the schedule's step count."""
        opt = self.optimizer.state_dict()
        opt["state"] = {i: {k: v.to("cpu", copy=True) if torch.is_tensor(v)
                            else v for k, v in st.items()}
                        for i, st in opt["state"].items()}
        avg = getattr(self.backbone, "avg_image", None)
        return {"backbone": {k: v.cpu() for k, v in
                             self.backbone.state_dict().items()},
                "head": {"weight": self.head_weight.detach().cpu()},
                "optimizer": opt, "opt_count": self.opt_count,
                "avg_image": None if avg is None
                else avg.permute(1, 2, 0).cpu()}

    def load_state_dict(self, ckpt: Dict) -> None:
        self.backbone.load_state_dict(ckpt["backbone"], strict=True)
        with torch.no_grad():
            self.head_weight.copy_(ckpt["head"]["weight"])
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.opt_count = int(ckpt["opt_count"])
