"""Carry weights from the JAX package's (params, state) trees into the port.

``from_jax`` walks the port's module tree and reads, for each module, its
entry in the JAX trees (nested dicts of arrays keyed like the module names;
a child such as ``styles.3`` or ``blocks.0`` is one key there). The layout
rules are those of the reference torch export:

  * ``nn.Conv2d``, ``EqualConv2d`` and the synthesis/torgb conv weights:
    HWIO -> OIHW;
    this covers ``losses.perceptual.LPIPS`` too: its trunk convolutions
    (``net.0``, ``net.3``, ...) and its ``lin.{i}`` weights, (1, 1, C, 1)
    -> (1, C, 1, 1);
  * ``nn.Linear``: (in, out) -> (out, in); after a ``Flatten`` of an
    (H, W) map (the face-recognition ``output_layer.3``: (7, 7, 512)) the
    input axis is also permuted from the JAX package's (H, W, C) order to
    (C, H, W);
  * ``FullyConnectedLayer`` / ``EqualLinear``: (out, in) kept;
  * a discriminator ``ConvLayer``'s activation bias (``FusedLeakyReLU``)
    at its child ``1`` or, after a blur, ``2``;
  * ``SynthesisPrologue.const``: HWC -> CHW;
  * BatchNorm2d and BatchNorm1d ``mean``/``var`` state ->
    ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``);
  * ``noise_const`` and the mapping network's ``w_avg`` (when it tracks
    one) from state;
  * ``PSpFaceRec.avg_image``: state (H, W, 3) -> buffer (3, H, W);
  * the margin heads of ``models.heads``: their parameters and buffers
    under the JAX names, unchanged (a class weight stays (C, D)).

A stage-3 backbone thus loads whole (``PSpFaceRec``, ``Backbone``), and
``load_stage3_from_jax`` fills a ``Stage3Trainer`` from the JAX trainer's
trees; ``load_stage1_from_jax`` fills a ``Stage1Trainer`` from the JAX
stage-1 train state; ``load_e4e_from_jax`` fills an ``E4eCoach`` from the
JAX e4e coach's (params, state, d_params). The pSp encoder family
(``GradualStyleEncoder``, ``ResNetBackboneEncoder``, the "pSp" and "both"
heads) and the e4e modules are made of the layers above.
``PSp.latent_avg`` is out of band: not in the state_dict, set by
``load_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models import heads
from ..models.psp import PSp, PSpFaceRec
from ..models.stylegan2 import EqualConv2d, EqualLinear, FusedLeakyReLU
from ..nn.layers import Flatten
from ..models.stylegan2_ada import (FullyConnectedLayer, MappingNetwork,
                                    SynthesisLayer, SynthesisPrologue,
                                    ToRGBLayer)


def _subtree(tree: Mapping, path: str):
    """The entry of module ``path`` (dotted torch name) in a JAX tree, or {}."""
    node, parts, i = tree, path.split(".") if path else [], 0
    while i < len(parts):
        if parts[i] in node:
            node, i = node[parts[i]], i + 1
        elif i + 1 < len(parts) and f"{parts[i]}.{parts[i + 1]}" in node:
            node, i = node[f"{parts[i]}.{parts[i + 1]}"], i + 2
        else:
            return {}
    return node


def _oihw(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _flattened_maps(model: nn.Module) -> Dict[str, Tuple[int, int]]:
    """{name of a Linear that follows a Flatten in a Sequential: the
    flattened map's (H, W)}."""
    out = {}
    for name, mod in model.named_modules():
        if not isinstance(mod, nn.Sequential):
            continue
        kids = list(mod.named_children())
        for (_, a), (k, b) in zip(kids, kids[1:]):
            if isinstance(a, Flatten) and isinstance(b, nn.Linear):
                if a.hw is None:
                    raise ValueError(f"{name}: a Flatten before a Linear "
                                     f"needs its map's hw to convert")
                out[f"{name}.{k}" if name else k] = a.hw
    return out


def _linear_weight(w, hw) -> np.ndarray:
    """JAX (in, out) -> torch (out, in); with ``hw`` the input axis goes
    from (H, W, C) to (C, H, W) order."""
    w = np.asarray(w)
    if hw is None:
        return w.T
    h, wd = hw
    o = w.shape[1]
    return w.reshape(h, wd, -1, o).transpose(3, 2, 0, 1).reshape(o, -1)


def _local_arrays(mod: nn.Module, p: Mapping, s: Mapping,
                  hw=None) -> Dict[str, np.ndarray]:
    """The arrays that ``mod`` itself owns, under their torch names."""
    if isinstance(mod, nn.Conv2d):
        out = {"weight": _oihw(p["weight"])}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, nn.Linear):
        out = {"weight": _linear_weight(p["weight"], hw)}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, PSpFaceRec):
        return {"avg_image": np.transpose(np.asarray(s["avg_image"]),
                                          (2, 0, 1))}
    if isinstance(mod, (heads._Head, heads.AmSoftmax)):
        own = [k for k, _ in mod.named_parameters(recurse=False)]
        own += [k for k, _ in mod.named_buffers(recurse=False)]
        return {k: p[k] if k in p else s[k] for k in own}
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return {"weight": p["weight"], "bias": p["bias"],
                "running_mean": s["mean"], "running_var": s["var"],
                "num_batches_tracked": np.asarray(0, dtype=np.int64)}
    if isinstance(mod, nn.PReLU):
        return {"weight": p["weight"]}
    if isinstance(mod, (FullyConnectedLayer, EqualLinear)):
        out = {"weight": p["weight"]}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, EqualConv2d):
        out = {"weight": _oihw(p["weight"])}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, FusedLeakyReLU):
        return {"bias": p["bias"]}
    if isinstance(mod, SynthesisLayer):
        return {"weight": _oihw(p["weight"]), "bias": p["bias"],
                "noise_strength": p["noise_strength"],
                "noise_const": s["noise_const"]}
    if isinstance(mod, ToRGBLayer):
        return {"weight": _oihw(p["weight"]), "bias": p["bias"]}
    if isinstance(mod, SynthesisPrologue):
        return {"const": np.transpose(np.asarray(p["const"]), (2, 0, 1))}
    if isinstance(mod, MappingNetwork) and mod.w_avg is not None:
        return {"w_avg": s["w_avg"]}
    return {}


def from_jax(model: nn.Module, params: Mapping, state: Mapping
             ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for ``model`` from the JAX trees. Raises if a
    key of ``model.state_dict()`` is not produced or a produced key is not
    the model's."""
    sd = {}
    maps = _flattened_maps(model)
    for name, mod in model.named_modules():
        local = _local_arrays(mod, _subtree(params, name),
                              _subtree(state, name), maps.get(name))
        for k, v in local.items():
            sd[f"{name}.{k}" if name else k] = torch.from_numpy(
                np.array(v, copy=True))
    want = set(model.state_dict())
    if set(sd) != want:
        raise KeyError(f"from_jax: missing {sorted(want - set(sd))[:10]}, "
                       f"unexpected {sorted(set(sd) - want)[:10]}")
    return sd


def load_from_jax(model: nn.Module, params: Mapping,
                  state: Mapping) -> nn.Module:
    """Load ``from_jax`` strictly into ``model`` (a ``PSp``, a stage-3
    ``PSpFaceRec`` or ``Backbone``, or any port module); a ``PSp`` also
    gets its out-of-band ``latent_avg`` from ``state``."""
    model.load_state_dict(from_jax(model, params, state), strict=True)
    if isinstance(model, PSp):
        with torch.no_grad():
            model.latent_avg.copy_(torch.from_numpy(
                np.asarray(state["latent_avg"], dtype=np.float32)))
    return model


def load_stage3_from_jax(trainer, params: Mapping, state: Mapping):
    """Fill a ``train.stage3.Stage3Trainer`` from the JAX trainer's trees
    (``params`` {"backbone", "head": {"weight"}}, ``state``
    {"backbone"}): the backbone strictly, the (C, D) class weight as it
    is. The optimizer state is not carried."""
    load_from_jax(trainer.backbone, params["backbone"], state["backbone"])
    with torch.no_grad():
        trainer.head_weight.copy_(torch.from_numpy(
            np.array(params["head"]["weight"], np.float32)))
    return trainer


def load_stage1_from_jax(trainer, jax_state: Mapping):
    """Fill a ``train.stage1.Stage1Trainer`` from the JAX trainer's train
    state (``Stage1Trainer.init``'s dict): G and g_ema strictly with the
    generator state (``w_avg``, ``noise_const``), D, ``ada_p``, the r_t
    accumulators, ``pl_mean`` and ``step``. Adam's moments are not carried
    (a fresh JAX state has none to carry)."""
    g_state = jax_state["g_state"]
    load_from_jax(trainer.G, jax_state["g"], g_state)
    load_from_jax(trainer.g_ema, jax_state["g_ema"], g_state)
    load_from_jax(trainer.D, jax_state["d"], {})
    for k in ("ada_p", "rt_accum", "rt_count", "pl_mean"):
        setattr(trainer, k, torch.tensor(np.asarray(jax_state[k]),
                                         dtype=torch.float32,
                                         device=trainer.device))
    trainer.step = int(np.asarray(jax_state["step"]))
    return trainer


def load_e4e_from_jax(coach, params: Mapping, state: Mapping,
                      d_params: Mapping):
    """Fill a ``train.stage2_e4e.E4eCoach`` from the JAX e4e coach's
    trees: the ``E4e`` strictly with its ``latent_avg``, the latent
    discriminator strictly. Optimizer states are not carried (a fresh JAX
    coach has none to carry)."""
    load_from_jax(coach.model, params, state)
    load_from_jax(coach.discriminator, d_params, {})
    return coach
