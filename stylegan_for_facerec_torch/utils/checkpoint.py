"""The port's checkpoints.

  * ``save_checkpoint``/``load_checkpoint``: one ``torch.save`` file of a
    ``PSp`` (inversion and stage 2): the state_dict, the out-of-band
    ``latent_avg`` and, when known, ``avg_image`` ((H, W, 3) in [-1, 1]).
  * ``CheckpointManager``: the training runs' step-indexed files. A
    stage-2 file adds the Ranger state to the ``save_checkpoint`` keys; a
    stage-3 file holds ``Stage3Trainer.state_dict()``'s payload
    (``backbone`` state_dict with its ``avg_image`` buffer, ``head``,
    ``optimizer``, ``opt_count``, ``avg_image``) and the epoch in its
    metadata.
    An e4e file (``tools/train_stage2_e4e.py``) adds to the stage-2 keys
    the latent discriminator (``discriminator``) and its Adam state
    (``d_optimizer``); it loads as a ``PSp`` with ``load_checkpoint`` too.
    A stage-1 file holds ``Stage1Trainer.state_dict()``: ``g``, ``d``,
    ``g_ema`` (each a state_dict with its buffers: ``w_avg``,
    ``noise_const``), ``opt_g``, ``opt_d``, ``ada_p``, ``rt_accum``,
    ``rt_count``, ``pl_mean`` and ``step``.
  * ``load_generator_handoff``: the stage-1 -> stage-2 handoff, a stage-1
    run directory's ``g_ema`` (or a torch ADA checkpoint's ``G.*`` keys)
    into the pSp decoder.
  * ``load_stage2_encoder``: the stage-2 -> stage-3 handoff, a stage-2
    ``PSp`` state_dict's ``encoder.input_layer`` and ``encoder.body`` into
    a ``PSpFaceRec``; ``load_backbone``: a stage-3 file's backbone.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional

import torch
from torch import nn

from ..models.psp import PSp, PSpFaceRec


def save_checkpoint(path: str, model: PSp,
                    avg_image: Optional[torch.Tensor] = None) -> None:
    """Write a ``PSp``'s weights, ``latent_avg`` and ``avg_image``: the
    inversion CLI's input, and a stage-2 encoder that
    ``load_stage2_encoder`` hands to stage 3. A stage-3 backbone is saved
    with its trainer through ``CheckpointManager``."""
    torch.save({"state_dict": {k: v.cpu() for k, v in
                               model.state_dict().items()},
                "latent_avg": model.latent_avg.cpu(),
                "avg_image": None if avg_image is None else avg_image.cpu()},
               path)


def load_checkpoint(path: str, model: PSp) -> Optional[torch.Tensor]:
    """Load a ``save_checkpoint`` file, or a stage-2 ``CheckpointManager``
    file, into a ``PSp`` strictly (weights and ``latent_avg``); returns the
    stored ``avg_image`` (on the CPU) or None. A stage-3 file loads with
    ``load_backbone`` or ``Stage3Trainer.load_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    with torch.no_grad():
        model.latent_avg.copy_(ckpt["latent_avg"])
    return ckpt.get("avg_image")


def load_generator_handoff(path: str, decoder: nn.Module) -> str:
    """Load the stage-2 CLI's ``--stylegan_weights`` into ``decoder`` (a
    ``models.stylegan2_ada.Generator``) strictly, and name the source:
    a directory is a stage-1 run (``tools/train_stage1.py``), whose newest
    checkpoint's ``g_ema`` loads, buffers (``w_avg``, ``noise_const``)
    included; a file is a torch StyleGAN2-ADA checkpoint whose ``G.*`` keys
    load. A directory without a checkpoint or a ``g_ema`` entry, or a
    ``g_ema`` of another layout (image size, z/w width, mapping depth),
    raises ``SystemExit``."""
    if os.path.isdir(path):
        latest = CheckpointManager(path).latest()
        if latest is None:
            raise SystemExit(f"{path}: no step_*.pt checkpoint; expected a "
                             f"tools/train_stage1.py run directory")
        ckpt = torch.load(latest, map_location="cpu", weights_only=True)
        if "g_ema" not in ckpt:
            raise SystemExit(f"{latest} has no 'g_ema' entry; expected a "
                             f"tools/train_stage1.py run directory")
        try:
            decoder.load_state_dict(ckpt["g_ema"], strict=True)
        except RuntimeError as e:
            raise SystemExit(
                f"{latest}: the stage-1 g_ema does not match this decoder "
                f"(another image size, z/w width or mapping depth?): "
                f"{str(e)[:300]}") from e
        return "stage-1 run dir"
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    decoder.load_state_dict({k[2:]: v for k, v in sd.items()
                             if k.startswith("G.")}, strict=True)
    return "torch ADA checkpoint"


def load_stage2_encoder(backbone: PSpFaceRec,
                        stage2_state_dict: Mapping[str, torch.Tensor]
                        ) -> None:
    """The stage-2 -> stage-3 handoff: load a stage-2 ``PSp`` state_dict's
    ``encoder.input_layer.*`` and ``encoder.body.*`` strictly into
    ``backbone.encoder``; its output layer keeps its own weights. Raises
    if the encoders' layouts differ."""
    enc = backbone.encoder
    for part in ("input_layer", "body"):
        prefix = f"encoder.{part}."
        sub = {k[len(prefix):]: v for k, v in stage2_state_dict.items()
               if k.startswith(prefix)}
        getattr(enc, part).load_state_dict(sub, strict=True)


def load_backbone(path: str, backbone: nn.Module) -> None:
    """Load a stage-3 checkpoint's backbone strictly into ``backbone``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    backbone.load_state_dict(ckpt["backbone"], strict=True)


def load_metadata(path: str) -> Dict:
    """The ``metadata`` dict of a ``CheckpointManager`` file (memory-mapped:
    the tensors are not read)."""
    return torch.load(path, map_location="cpu", weights_only=True,
                      mmap=True).get("metadata", {})


class CheckpointManager:
    """Step-indexed ``torch.save`` files under ``root``:
    ``step_{step:09d}.pt``, the newest ``keep`` kept, and ``best.pt`` for
    the lowest metric seen (recovered from an existing ``best.pt``, so a
    resumed run cannot overwrite it with a worse model). Each file holds
    the caller's payload plus ``metadata`` (``step``, ``metric`` when
    given, and the caller's keys, such as ``preempted``). A payload with
    ``state_dict`` and ``latent_avg`` also loads with
    ``load_checkpoint``."""

    def __init__(self, root: str, keep: int = 5):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self.best: Optional[float] = None
        best = os.path.join(root, "best.pt")
        if os.path.exists(best):
            self.best = load_metadata(best).get("metric")

    def step_path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}.pt")

    def _write(self, path: str, payload: Dict) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save(self, step: int, payload: Dict, metric: Optional[float] = None,
             metadata: Optional[Dict] = None) -> str:
        meta = dict(metadata or {}, step=int(step))
        if metric is not None:
            meta["metric"] = float(metric)
        payload = dict(payload, metadata=meta)
        path = self.step_path(step)
        self._write(path, payload)
        if metric is not None and (self.best is None or metric < self.best):
            self.best = float(metric)
            self._write(os.path.join(self.root, "best.pt"), payload)
        for old in self._steps()[:-self.keep]:
            os.remove(os.path.join(self.root, old))
        return path

    def _steps(self) -> List[str]:
        return sorted(f for f in os.listdir(self.root)
                      if f.startswith("step_") and f.endswith(".pt"))

    def latest(self) -> Optional[str]:
        steps = self._steps()
        return os.path.join(self.root, steps[-1]) if steps else None
