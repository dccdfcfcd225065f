"""Entry ``stage3_train``: the port's ``train/stage3.py::Stage3Trainer.
train_step`` in a closed loop, one process per card, data-parallel over
the port's mesh when the cell has several.

Set-up builds the trainer (``PSpFaceRec`` with the configuration's block
dropout, ArcFace, focal loss, SGD, ``freeze_backbone_epochs`` 0, bf16),
gives it the benchmark's weights (drawn on the device from the seed),
draws the traffic's pool of distinct uint8 batches and labels on the
device (every rank its own), and drives the same trainer through the
first ``compared_steps`` steps of the pool: their losses, the first
gradient as SGD's momentum buffer holds it after step 1 (less the weight
decay) and the parameters' change after the last are read then, before
the window moves them. The window continues with that trainer. After it,
``check`` frees the trainer and runs the plain reference
(``reference/facerec.py``) from the same seed over the same batches.
"""

from __future__ import annotations

from typing import Dict

import torch

from port_bench.counts.flops import train_step_flops
from port_bench.harness import compare, weights
from port_bench.reference.facerec import (Stage3Reference,
                                          step_weight_table)
from port_bench.reference.ops import Precision, no_tf32


def _state(ctx) -> Dict[str, torch.Tensor]:
    return weights.draw(step_weight_table(ctx.cfg), ctx.seed, ctx.device)


def _pool(ctx):
    """(images (pool, batch, size, size, 3) uint8, labels (pool, batch)):
    this rank's batches, each row drawn anew."""
    t, c = ctx.traffic, ctx.cfg
    g = weights.generator(ctx.device, ctx.seed, "pool", ctx.rank)
    n, b, s = t["pool"], t["batch_per_chip"], c["input_size"]
    images = torch.randint(0, 256, (n, b, s, s, 3), generator=g,
                           device=ctx.device, dtype=torch.uint8)
    labels = torch.randint(0, c["num_classes"], (n, b), generator=g,
                           device=ctx.device)
    return images, labels


def trainer_seed(ctx) -> int:
    return weights.derive(ctx.seed, "trainer")


class Stage3Train:
    def __init__(self, ctx):
        from stylegan_for_facerec_torch.models.psp import PSpFaceRec
        from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                             Stage3Trainer)
        c, t = ctx.cfg, ctx.traffic
        self.ctx = ctx
        self.items_per_call = t["batch_per_chip"] * ctx.world
        self.trace_calls = t["trace_calls"]
        self.flops_per_call = ctx.world * train_step_flops(
            c, t["batch_per_chip"])
        self.images, self.labels = _pool(ctx)
        state = _state(ctx)
        with torch.device(ctx.device):
            backbone = PSpFaceRec(size=c["input_size"],
                                  num_layers=c["num_layers"],
                                  emb_size=c["emb_size"],
                                  block_dropout=c["dropout"] or None)
        cfg = Stage3Config(
            emb_size=c["emb_size"], num_classes=c["num_classes"],
            head=c["head"], loss=c["loss"], arcface_s=c["arcface_s"],
            margin=c["margin"], lr=c["lr"], momentum=c["momentum"],
            weight_decay=c["weight_decay"],
            batch_size=t["batch_per_chip"] * ctx.world,
            num_epochs=c["num_epochs"], stages=tuple(c["stages"]),
            freeze_backbone_epochs=c["freeze_backbone_epochs"],
            compute_dtype=c["compute_dtype"], augment_crop=None)
        self.trainer = Stage3Trainer(
            backbone, cfg, steps_per_epoch=c["steps_per_epoch"],
            device=str(ctx.device), seed=trainer_seed(ctx), mesh=ctx.mesh)
        with torch.no_grad():
            backbone.load_state_dict({k[len("backbone."):]: v for k, v in
                                      state.items()
                                      if k.startswith("backbone.")})
            self.trainer.head_weight.copy_(state["head.weight"])
        self.bad = torch.zeros((), dtype=torch.int64, device=ctx.device)
        self.readings = self._first_steps(state, t["compared_steps"])
        self.first_call = t["compared_steps"]
        for i in range(self.first_call, self.first_call + t["warmup_steps"]):
            self.call(i)
        self.first_call += t["warmup_steps"]
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)

    def _step(self, i: int):
        p = i % self.ctx.traffic["pool"]
        return self.trainer.train_step(self.images[p], self.labels[p], i)

    def _first_steps(self, p0, n: int) -> dict:
        """The compared steps: losses, first gradient norms, change norms
        (the program's own, or with a variant the control's or a planted
        fault's)."""
        variant = self.ctx.variant
        if variant == "control":
            return self._control_steps(p0, n)
        tr = self.trainer
        named = dict(tr.named_parameters())
        decay = {id(p): g["weight_decay"] for g in tr.optimizer.param_groups
                 for p in g["params"]}
        if variant == "no_exchange":
            tr._sync_grads = lambda: None
        losses, grad_norms = [], None
        for i in range(n):
            if variant == "unchanged_state":
                before = {k: v.detach().clone() for k, v in named.items()}
            m = self._step(i) if variant != "half_batch" else \
                tr.train_step(self.images[i][:len(self.images[i]) // 2],
                              self.labels[i][:len(self.labels[i]) // 2], i)
            losses.append(m["loss"])
            if i == 0:
                grad_norms = compare.leaf_norms({
                    k: tr.optimizer.state[p]["momentum_buffer"]
                    - decay[id(p)] * p0[k] for k, p in named.items()})
            if variant == "unchanged_state":
                with torch.no_grad():
                    for k, v in named.items():
                        v.copy_(before[k])
        change = compare.leaf_norms({k: p.detach() - p0[k]
                                     for k, p in named.items()})
        if variant == "no_exchange":
            del tr._sync_grads
        return {"losses": [float(x) for x in losses],
                "grad_norms": grad_norms, "change_norms": change}

    def _control_steps(self, p0, n: int) -> dict:
        with no_tf32():
            ref = self._reference(Precision("fp8"))
            return self._follow(ref, p0, n)

    def _reference(self, prec: Precision) -> Stage3Reference:
        ctx = self.ctx
        return Stage3Reference(
            _state(ctx), ctx.cfg, ctx.device, trainer_seed(ctx), prec,
            rows=(ctx.rank, ctx.world), sum_=ctx.sum_)

    def _follow(self, ref: Stage3Reference, p0, n: int) -> dict:
        losses, grad_norms = [], None
        for i in range(n):
            loss, grads = ref.step(self.images[i], self.labels[i])
            losses.append(loss)
            if i == 0:
                grad_norms = compare.leaf_norms(grads)
            del grads
        change = compare.leaf_norms({k: p.detach() - p0[k]
                                     for k, p in ref.params.items()})
        return {"losses": losses, "grad_norms": grad_norms,
                "change_norms": change}

    # -- the window --------------------------------------------------------

    def call(self, i: int) -> None:
        m = self._step(i)
        self.bad += ~torch.isfinite(m["loss"])

    def failed(self) -> int:
        return int(self.bad)

    def release(self) -> None:
        self.trainer = None

    def check(self) -> Dict[str, float]:
        ctx = self.ctx
        with no_tf32():
            ref = self._reference(Precision("fp32"))
            want = self._follow(ref, _state(ctx), ctx.traffic[
                "compared_steps"])
        del ref
        got = self.readings
        leaves = compare.counted_leaves(want["grad_norms"])
        grad, grad_leaf = compare.norm_gap(got["grad_norms"],
                                           want["grad_norms"], leaves)
        change, change_leaf = compare.norm_gap(got["change_norms"],
                                               want["change_norms"], leaves)
        self.details = {"worst_grad_leaf": grad_leaf,
                        "worst_change_leaf": change_leaf,
                        "left_out": sorted(set(want["grad_norms"]) - leaves)}
        return {"loss_gap": compare.loss_gap(got["losses"], want["losses"]),
                "grad_norm_gap": grad, "change_norm_gap": change}


def setup(ctx) -> Stage3Train:
    return Stage3Train(ctx)

