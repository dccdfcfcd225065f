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
    a ``PSpFaceRec`` (a file of this package, or a reference torch
    ``.pt``: the same module names); ``load_backbone``: a stage-3 file's
    backbone.
  * ``resolve_checkpoint_dir``: a run directory to its newest checkpoint,
    in this package's layout or the JAX package's; ``load_checkpoint``,
    ``load_backbone``, ``load_metadata`` and ``read_jax_checkpoint`` take
    a run directory through it.
  * ``read_jax_checkpoint``: a checkpoint directory of the JAX package's
    npz format, read without JAX: its ``leaves.npz`` placed by the
    ``manifest.json`` tree description, as nested dicts of numpy arrays
    (what ``utils.convert.from_jax`` takes).
  * ``write_jax_checkpoint``: the inverse, nested dicts of arrays written
    as the JAX package's npz checkpoint (``manifest.json`` +
    ``leaves.npz``) with numpy alone.
  * ``load_state_dict_file``: a ``torch.save``d state_dict, bare or under
    ``state_dict`` (the ``save_checkpoint`` layout), into any module;
    ``load_inception`` reads a torchvision or pytorch-fid InceptionV3
    file that way, its ``fc.`` and ``AuxLogits.`` keys dropped.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

import torch
from torch import nn

from ..models.psp import PSp, PSpFaceRec


def resolve_checkpoint_dir(path: str) -> str:
    """A checkpoint, or a training run's directory resolved to its newest
    checkpoint, as the JAX package's ``resolve_checkpoint_dir``: a file or
    a directory with ``manifest.json`` comes back as it is; a run
    directory goes to its newest ``step_*`` (``step_{step:09d}.pt`` of
    ``CheckpointManager``, or the JAX package's ``step_*/``), else to its
    ``best`` (``best.pt`` or ``best/``); anything else comes back
    unchanged. So the eval CLIs take a run directory for a checkpoint."""
    if os.path.isfile(path) or os.path.exists(
            os.path.join(path, "manifest.json")):
        return path
    if os.path.isdir(path):
        # a CheckpointManager write in flight is a ``.tmp`` file
        steps = sorted(d for d in os.listdir(path)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        if steps:
            return os.path.join(path, steps[-1])
        if os.path.exists(os.path.join(path, "best", "manifest.json")):
            return os.path.join(path, "best")
        if os.path.isfile(os.path.join(path, "best.pt")):
            return os.path.join(path, "best.pt")
    return path


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
    stored ``avg_image`` (on the CPU) or None. ``path`` may be a run
    directory (``resolve_checkpoint_dir``). A stage-3 file loads with
    ``load_backbone`` or ``Stage3Trainer.load_state_dict``."""
    ckpt = torch.load(resolve_checkpoint_dir(path), map_location="cpu",
                      weights_only=True)
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
    """Load a stage-3 checkpoint's backbone strictly into ``backbone``;
    ``path`` may be a run directory (``resolve_checkpoint_dir``)."""
    ckpt = torch.load(resolve_checkpoint_dir(path), map_location="cpu",
                      weights_only=True)
    backbone.load_state_dict(ckpt["backbone"], strict=True)


def load_state_dict_file(path: str, module: nn.Module,
                         drop_prefixes=()) -> None:
    """Load a ``torch.save``d state_dict (bare, or under ``state_dict``)
    strictly into ``module``, without its keys under ``drop_prefixes``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    module.load_state_dict({k: v for k, v in sd.items()
                            if not k.startswith(tuple(drop_prefixes))},
                           strict=True)


def load_inception(path: str, model: nn.Module) -> None:
    """An ``InceptionV3`` from a file of this package (its state_dict, bare
    or under ``state_dict``) or a torchvision / pytorch-fid state_dict,
    whose classifier heads (``fc.``, ``AuxLogits.``) the feature extractor
    does not own."""
    load_state_dict_file(path, model, ("fc.", "AuxLogits."))


def load_metadata(path: str) -> Dict:
    """The ``metadata`` dict of a ``CheckpointManager`` file (memory-mapped:
    the tensors are not read); ``path`` may be a run directory."""
    return torch.load(resolve_checkpoint_dir(path), map_location="cpu",
                      weights_only=True, mmap=True).get("metadata", {})


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


# -- the JAX package's npz checkpoints ---------------------------------------

def _treedef_leaf_paths(desc: str) -> List[Tuple]:
    """The path of every leaf of a ``str(PyTreeDef)`` description, in
    flatten order. A dict contributes its key, a tuple, list or custom
    node's child list its position; a leaf is ``*``, ``None`` holds none,
    and a custom node's metadata (``namedtuple[TraceState]``) holds none.
    """
    pos, paths = 0, []

    def ws():
        nonlocal pos
        while pos < len(desc) and desc[pos].isspace():
            pos += 1

    def string():
        nonlocal pos
        quote, start = desc[pos], pos
        pos += 1
        while desc[pos] != quote:
            pos += 2 if desc[pos] == "\\" else 1
        pos += 1
        return ast.literal_eval(desc[start:pos])

    def skip_group():
        nonlocal pos
        depth = 0
        while True:
            c = desc[pos]
            if c in "'\"":
                string()
                continue
            depth += c in "([{"
            depth -= c in ")]}"
            pos += 1
            if depth == 0:
                return

    def items(close, path, keyed):
        nonlocal pos
        pos += 1
        i = 0
        while True:
            ws()
            if desc[pos] == close:
                pos += 1
                return
            key = i
            if keyed:
                key = string() if desc[pos] in "'\"" else int(
                    re.match(r"-?\d+", desc[pos:]).group())
                if not isinstance(key, str):
                    pos += len(str(key))
                ws()
                pos += 1                           # ':'
            value(path + (key,))
            i += 1
            ws()
            if desc[pos] == ",":
                pos += 1

    def value(path):
        nonlocal pos
        ws()
        c = desc[pos]
        if c == "*":
            paths.append(path)
            pos += 1
        elif c == "{":
            items("}", path, True)
        elif c in "([":
            items(")" if c == "(" else "]", path, False)
        elif c in "'\"":
            string()
        else:
            name = re.match(r"[\w.]*", desc[pos:]).group()
            pos += len(name)
            if pos < len(desc) and desc[pos] == "(" and name != "None":
                items(")", path, False)
            elif pos < len(desc) and desc[pos] == "[":
                skip_group()
            elif not name:
                raise ValueError(f"tree description: unexpected {c!r} at "
                                 f"{pos}")

    ws()
    if not desc.startswith("PyTreeDef("):
        raise ValueError("not a PyTreeDef description")
    pos = len("PyTreeDef")
    items(")", (), False)
    return [p[1:] for p in paths]


def read_jax_checkpoint(path: str) -> Dict:
    """A JAX npz checkpoint directory (or run directory) as nested dicts
    of numpy arrays, keyed as the saved tree's dicts; the entries of a
    tuple, list or custom node (an optimizer state) are keyed by position.
    Reads ``manifest.json``'s tree description and ``leaves.npz``; the
    pickled ``treedef.pkl`` needs JAX and is not read. A checkpoint of
    the ``orbax`` backend is refused."""
    ckpt = resolve_checkpoint_dir(path)
    if not os.path.exists(os.path.join(ckpt, "manifest.json")):
        raise SystemExit(f"{path}: no manifest.json, step_* or best/ "
                         f"checkpoint of the JAX package")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("backend", "npz") != "npz":
        raise SystemExit(f"{ckpt}: a {manifest['backend']} checkpoint; only "
                         f"the JAX package's npz checkpoints are read "
                         f"(save with backend='npz')")
    paths = _treedef_leaf_paths(manifest["treedef"])
    data = np.load(os.path.join(ckpt, "leaves.npz"))
    if len(paths) != len(data.files) or len(paths) != manifest.get(
            "n_leaves", len(paths)):
        raise ValueError(f"{ckpt}: the tree description has {len(paths)} "
                         f"leaves, leaves.npz {len(data.files)}")
    tree: Dict = {}
    for i, p in enumerate(paths):
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = data[f"leaf_{i}"]
    return tree


def _describe(tree) -> Tuple[str, List]:
    """``str(PyTreeDef)`` of nested dicts and their leaves in JAX's flatten
    order (keys sorted)."""
    if not isinstance(tree, Mapping):
        return "*", [tree]
    parts, leaves = [], []
    for k in sorted(tree):
        d, l = _describe(tree[k])
        parts.append(f"{k!r}: {d}")
        leaves += l
    return "{" + ", ".join(parts) + "}", leaves


def write_jax_checkpoint(path: str, tree: Mapping,
                         metadata: Optional[Dict] = None) -> None:
    """Write nested dicts of arrays as a checkpoint directory of the JAX
    package's npz format, with numpy alone: ``leaves.npz`` (``leaf_i`` in
    JAX's flatten order) and ``manifest.json`` (the tree description
    ``str(PyTreeDef)``, ``n_leaves``, ``backend`` "npz", ``metadata``).
    The pickled tree definition needs JAX and is not written
    (``treedef_pickled`` false): the JAX package's ``load_checkpoint``
    reads the directory with ``like=`` a tree of the same structure, and
    ``read_jax_checkpoint`` reads it without one."""
    os.makedirs(path, exist_ok=True)
    desc, leaves = _describe(tree)
    np.savez(os.path.join(path, "leaves.npz"),
             **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"treedef": f"PyTreeDef({desc})",
                   "n_leaves": len(leaves), "backend": "npz",
                   "treedef_pickled": False,
                   "metadata": metadata or {}}, f)
