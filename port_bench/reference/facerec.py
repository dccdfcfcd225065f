"""Plain reference of the stage-3 training step: ``PSpFaceRec`` (the image
and a fixed average image into an IR-SE-50 with block dropout), the
ArcFace head, the focal loss of the mean cross-entropy and SGD with
momentum, weight decay on all but BatchNorm, and the step schedule's lr.

Written from the architecture as the port implements it, at commit
dd4ae0b: ``stylegan_for_facerec_torch/models/irse.py``, ``models/psp.py``
(``PSpFaceRec``, ``BackboneEncoderDiffHead``), ``models/heads.py``
(``arcface_margin``), ``parallel/sharded_head.py`` (``margin_logits``,
``local_margin_ce``), ``losses/focal.py`` (``focal_of_mean``),
``train/optim.py`` (``Stage3Schedule``, ``batchnorm_decay_mask``) and
``train/stage3.py`` (the step). Parameter and buffer names are the port's,
so one state dict fits both; nothing here imports the port.

Dropout masks are drawn as the trainer draws them: a ``torch.Generator``
on the device seeded with the trainer's seed, one ``bernoulli_`` over a
tensor of the compute dtype and the input's shape per dropout call, in
forward order; under data parallelism each call draws the global batch's
rows and keeps this rank's. Computed in float32 (``Precision("fp8")`` for
the control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .ops import Precision

IR_SE_LAYOUTS = {
    50: ((64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)),
}


def units(layout: Sequence[Tuple[int, int, int]]):
    """(in_channels, depth, stride) of each bottleneck unit."""
    out = []
    for cin, depth, n in layout:
        out += [(cin, depth, 2)] + [(depth, depth, 1)] * (n - 1)
    return out


class Masks:
    """Dropout masks from ``seed`` on ``device`` in ``dtype``; ``rows`` =
    (index, count): each draw covers ``count`` local batches and this
    process keeps the index-th. On the meta device nothing is drawn."""

    def __init__(self, seed: int, device, dtype=torch.bfloat16,
                 rows: Tuple[int, int] = (0, 1)):
        self.device = torch.device(device)
        self.dtype, self.rows = dtype, rows
        self.generator = None
        if self.device.type != "meta":
            self.generator = torch.Generator(self.device).manual_seed(seed)

    def drop(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0 or self.generator is None:
            return x
        keep = 1.0 - p
        index, count = self.rows
        n = x.shape[0]
        mask = torch.empty((n * count, *x.shape[1:]), dtype=self.dtype,
                           device=self.device).bernoulli_(
            keep, generator=self.generator)[index * n:(index + 1) * n]
        return x * mask.to(x.dtype) / keep


class Run:
    """What one forward pass needs: the precision, the masks (None: no
    dropout) and whether BatchNorm uses batch statistics."""

    def __init__(self, prec: Precision, masks: Optional[Masks],
                 training: bool):
        self.prec, self.masks, self.training = prec, masks, training

    def conv(self, conv: nn.Conv2d, x, stride=1, padding=0):
        return self.prec.conv2d(x, conv.weight, conv.bias, stride, padding)

    def bn(self, bn: nn.modules.batchnorm._BatchNorm, x):
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, self.training, 0.1, 1e-5)

    def drop(self, x, p: float):
        return x if self.masks is None else self.masks.drop(x, p)


class SE(nn.Module):
    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // reduction, 1, bias=False)
        self.fc2 = nn.Conv2d(c // reduction, c, 1, bias=False)

    def forward(self, x, run: Run):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(run.conv(self.fc2, torch.relu(run.conv(self.fc1,
                                                                   s))))
        return x * s


class Unit(nn.Module):
    """IR-SE bottleneck: shortcut (strided subsample, or 1x1 conv + BN) plus
    BN -> conv3x3 -> PReLU -> conv3x3(stride) -> BN -> SE, with dropout
    after each 3x3 conv and after a conv shortcut (drawn in that order:
    shortcut, first conv, second conv)."""

    def __init__(self, cin: int, depth: int, stride: int, p: float = 0.0):
        super().__init__()
        self.stride, self.p = stride, p
        self.conv_shortcut = cin != depth
        if self.conv_shortcut:
            self.shortcut_layer = nn.Sequential(
                nn.Conv2d(cin, depth, 1, bias=False), nn.BatchNorm2d(depth))
        self.res_layer = nn.Sequential(
            nn.BatchNorm2d(cin), nn.Conv2d(cin, depth, 3, bias=False),
            nn.PReLU(depth), nn.Conv2d(depth, depth, 3, bias=False),
            nn.BatchNorm2d(depth), SE(depth))

    def forward(self, x, run: Run):
        if self.conv_shortcut:
            conv, bn = self.shortcut_layer
            sc = run.drop(run.bn(bn, run.conv(conv, x, self.stride)), self.p)
        else:
            sc = x[:, :, ::self.stride, ::self.stride]
        r = self.res_layer
        h = run.drop(run.conv(r[1], run.bn(r[0], x), 1, 1), self.p)
        h = F.prelu(h, r[2].weight)
        h = run.drop(run.conv(r[3], h, self.stride, 1), self.p)
        return r[5](run.bn(r[4], h), run) + sc


def ir_body(layout, p: float = 0.0) -> nn.ModuleList:
    return nn.ModuleList(Unit(c, d, s, p) for c, d, s in units(layout))


def ir_input_layer(in_channels: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(in_channels, 64, 3, bias=False),
                         nn.BatchNorm2d(64), nn.PReLU(64))


def run_input_and_body(input_layer, body, x, run: Run):
    x = run.conv(input_layer[0], x, 1, 1)
    x = F.prelu(run.bn(input_layer[1], x), input_layer[2].weight)
    for unit in body:
        x = unit(x, run)
    return x


class FaceRecEncoder(nn.Module):
    """``BackboneEncoderDiffHead`` with the face-recognition output layer:
    BN2d(512) -> Dropout(0.5) -> flatten (C, H, W) -> Linear -> BN1d."""

    def __init__(self, layout, in_channels: int, emb_size: int, spatial: int,
                 block_dropout: float):
        super().__init__()
        self.input_layer = ir_input_layer(in_channels)
        self.body = ir_body(layout, block_dropout)
        self.output_layer = nn.Sequential(
            nn.BatchNorm2d(512), nn.Identity(), nn.Identity(),
            nn.Linear(512 * spatial * spatial, emb_size),
            nn.BatchNorm1d(emb_size))

    def forward(self, x, run: Run):
        x = run_input_and_body(self.input_layer, self.body, x, run)
        o = self.output_layer
        x = run.drop(run.bn(o[0], x), 0.5).flatten(1)
        x = run.prec.linear(x, o[3].weight, o[3].bias)
        return run.bn(o[4], x)


class FaceRecNet(nn.Module):
    """``PSpFaceRec``: uint8 NHWC images -> x / 127.5 - 1, NCHW, the average
    image (buffer ``avg_image``, (3, size, size)) concatenated channel-wise,
    into the encoder."""

    def __init__(self, size: int = 112, num_layers: int = 50,
                 emb_size: int = 512, block_dropout: float = 0.15):
        super().__init__()
        spatial = size
        for _ in range(4):
            spatial = -(-spatial // 2)
        self.encoder = FaceRecEncoder(IR_SE_LAYOUTS[num_layers], 6, emb_size,
                                      spatial, block_dropout)
        self.register_buffer("avg_image", torch.zeros(3, size, size))

    def forward(self, images: torch.Tensor, run: Run) -> torch.Tensor:
        x = images.float() / 127.5 - 1.0 if images.dtype == torch.uint8 \
            else images.float()
        x = x.permute(0, 3, 1, 2)
        avg = self.avg_image[None].expand(x.shape[0], -1, -1, -1)
        return self.encoder(torch.cat([x, avg.to(x.dtype)], dim=1), run)


def normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def arcface_ce(features, weight, labels, s: float, m: float,
               prec: Precision) -> torch.Tensor:
    """(B,) cross-entropies of the ArcFace logits: s cos(theta + m) on the
    target class (the sine clamped to [1e-10, 1 - 1e-10]; past theta =
    pi - m, cos - m sin(pi - m)), s cos(theta) elsewhere."""
    cosine = prec.matmul(normalize(features), normalize(weight).t())
    one_hot = torch.zeros_like(cosine).scatter_(1, labels.long()[:, None],
                                                1.0)
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 1e-10, 1 - 1e-10))
    phi = cosine * math.cos(m) - sine * math.sin(m)
    phi = torch.where(cosine > math.cos(math.pi - m), phi,
                      cosine - math.sin(math.pi - m) * m)
    logits = (one_hot * phi + (1.0 - one_hot) * cosine) * s
    return torch.logsumexp(logits, 1) - logits.gather(
        1, labels.long()[:, None])[:, 0]


def focal_of_mean(logp: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    return (1.0 - torch.exp(-logp)) ** gamma * logp


def schedule_lr(step: int, base_lr: float, steps_per_epoch: int,
                stages: Sequence[int], warmup: int = 0,
                factor: float = 1.5) -> float:
    if warmup > 0 and step < warmup:
        return base_lr * (step + 1) / warmup
    n = sum(1 for s in stages if step // steps_per_epoch >= s)
    return base_lr / factor ** n


class Stage3Reference:
    """The step on ``state`` (the port's names: ``backbone.<key>`` of the
    backbone's state dict and ``head.weight``), float32 on ``device``.

    ``rows`` = (index, count) is this process's slice of a data-parallel
    global batch: its BatchNorm sees its own rows, the loss is the focal
    transform of the global mean cross-entropy, and ``sum_`` (a callable
    summing a float32 tensor over the processes in place; None for one
    process) makes the mean and the gradients global."""

    def __init__(self, state: Dict[str, torch.Tensor], cfg: dict, device,
                 seed: int, prec: Precision = Precision("fp32"),
                 rows: Tuple[int, int] = (0, 1),
                 sum_: Optional[Callable[[torch.Tensor], None]] = None):
        self.cfg, self.rows, self.sum_ = cfg, rows, sum_
        self.prec = prec
        with torch.device("meta"):
            net = FaceRecNet(cfg["input_size"], cfg["num_layers"],
                             cfg["emb_size"], cfg["dropout"])
        net = net.to_empty(device=device)
        net.load_state_dict({k[len("backbone."):]: v for k, v in
                             state.items() if k.startswith("backbone.")})
        self.net = net.float().train()
        self.head = state["head.weight"].to(device, torch.float32).clone()
        self.head.requires_grad_(True)
        self.masks = Masks(seed, device, torch.bfloat16 if cfg[
            "compute_dtype"] == "bfloat16" else torch.float32, rows)
        bn = {f"backbone.{n}.{k}" for n, mod in self.net.named_modules()
              if isinstance(mod, nn.modules.batchnorm._BatchNorm)
              for k, _ in mod.named_parameters(recurse=False)}
        self.params = dict(self.named_parameters())
        self.decay = {k: (0.0 if k in bn else cfg["weight_decay"])
                      for k in self.params}
        self.momentum: Dict[str, torch.Tensor] = {}
        self.count = 0

    def named_parameters(self):
        for k, p in self.net.named_parameters():
            yield "backbone." + k, p
        yield "head.weight", self.head

    def loss(self, images, labels, run: Run) -> torch.Tensor:
        c = self.cfg
        feats = self.net(images, run)
        ce = arcface_ce(feats, self.head, labels, c["arcface_s"],
                        c["margin"], self.prec).mean()
        if self.sum_ is not None:
            total = ce.detach().clone()
            self.sum_(total)
            ce = ce / self.rows[1] + (total - ce.detach()) / self.rows[1]
        return focal_of_mean(ce)

    def step(self, images, labels) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One SGD step; returns the loss and each parameter's gradient as
        the optimizer gets it, before weight decay."""
        c = self.cfg
        for p in self.params.values():
            p.grad = None
        loss = self.loss(images, labels, Run(self.prec, self.masks, True))
        loss.backward()
        grads = {k: p.grad for k, p in self.params.items()}
        if self.sum_ is not None:
            flat = torch.cat([g.reshape(-1) for g in grads.values()])
            self.sum_(flat)
            grads = dict(zip(grads, torch.split(flat, [
                g.numel() for g in grads.values()])))
            grads = {k: g.view_as(self.params[k]) for k, g in grads.items()}
        lr = schedule_lr(self.count, c["lr"], c["steps_per_epoch"],
                         c["stages"])
        with torch.no_grad():
            for k, p in self.params.items():
                d = grads[k] + self.decay[k] * p if self.decay[k] else \
                    grads[k].clone()
                buf = self.momentum.get(k)
                buf = d if buf is None else buf.mul_(c["momentum"]).add_(d)
                self.momentum[k] = buf
                p.sub_(lr * buf)
        self.count += 1
        return float(loss.detach()), grads


def _rule(mod: nn.Module, mname: str, pname: str, t: torch.Tensor):
    """(mean, std) of a weight's normal draw by its module's kind; None
    for an integer buffer (kept at 0)."""
    if not t.is_floating_point():
        return None
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return {"weight": (0.2, 0.05) if mname.endswith("res_layer.4")
                else (1.0, 0.1), "bias": (0.0, 0.1),
                "running_mean": (0.0, 0.1), "running_var": (1.0, 0.05)}[pname]
    if isinstance(mod, nn.PReLU):
        return 0.25, 0.05
    if pname == "bias" or t.dim() < 2:
        return 0.0, 0.01
    if pname == "avg_image":
        return 0.0, 0.5
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    fan_out = t.shape[0] * math.prod(t.shape[2:])
    return 0.0, math.sqrt(2.0 / (fan_in + fan_out))


def weight_table(module: nn.Module, prefix: str = "") -> List[Tuple]:
    """(name, shape, dtype, (mean, std) or None) of every entry of
    ``module``'s state dict: the draw the benchmark makes its weights
    with. Convolutions and Linears xavier-normal; BatchNorm near identity,
    the residual branch's last one scaled down as in trained IR nets;
    PReLU near 0.25."""
    rows = []
    for mname, mod in module.named_modules():
        own = list(mod.named_parameters(recurse=False)) + [
            (k, b) for k, b in mod.named_buffers(recurse=False)
            if k not in mod._non_persistent_buffers_set]
        for pname, t in own:
            key = prefix + (f"{mname}.{pname}" if mname else pname)
            rows.append((key, tuple(t.shape), t.dtype,
                         _rule(mod, mname, pname, t)))
    return rows


def step_weight_table(cfg: dict) -> List[Tuple]:
    """The draw of the step's state: the backbone under ``backbone.`` and
    the head's (classes, emb) weight, xavier-normal."""
    with torch.device("meta"):
        net = FaceRecNet(cfg["input_size"], cfg["num_layers"],
                         cfg["emb_size"], cfg["dropout"])
    c, d = cfg["num_classes"], cfg["emb_size"]
    return weight_table(net, "backbone.") + [
        ("head.weight", (c, d), torch.float32,
         (0.0, math.sqrt(2.0 / (c + d))))]
