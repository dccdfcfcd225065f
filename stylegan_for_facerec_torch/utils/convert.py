"""Carry weights from the JAX package's (params, state) trees into the port.

``from_jax`` walks the port's module tree and reads, for each module, its
entry in the JAX trees (nested dicts of arrays keyed like the module names;
a child such as ``styles.3`` or ``blocks.0`` is one key there). The layout
rules are those of the reference torch export:

  * ``nn.Conv2d`` and the synthesis/torgb conv weights: HWIO -> OIHW;
    this covers ``losses.perceptual.LPIPS`` too: its trunk convolutions
    (``net.0``, ``net.3``, ...) and its ``lin.{i}`` weights, (1, 1, C, 1)
    -> (1, C, 1, 1);
  * ``FullyConnectedLayer`` / ``EqualLinear``: (out, in) kept;
  * ``SynthesisPrologue.const``: HWC -> CHW;
  * BatchNorm ``mean``/``var`` state -> ``running_mean``/``running_var``
    (plus a zero ``num_batches_tracked``);
  * ``noise_const`` and the mapping network's ``w_avg`` from state.

``PSp.latent_avg`` is out of band: not in the state_dict, set by
``load_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..models.psp import PSp
from ..models.stylegan2 import EqualLinear
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


def _local_arrays(mod: nn.Module, p: Mapping, s: Mapping) -> Dict[str, np.ndarray]:
    """The arrays that ``mod`` itself owns, under their torch names."""
    if isinstance(mod, nn.Conv2d):
        out = {"weight": _oihw(p["weight"])}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, nn.BatchNorm2d):
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
    if isinstance(mod, SynthesisLayer):
        return {"weight": _oihw(p["weight"]), "bias": p["bias"],
                "noise_strength": p["noise_strength"],
                "noise_const": s["noise_const"]}
    if isinstance(mod, ToRGBLayer):
        return {"weight": _oihw(p["weight"]), "bias": p["bias"]}
    if isinstance(mod, SynthesisPrologue):
        return {"const": np.transpose(np.asarray(p["const"]), (2, 0, 1))}
    if isinstance(mod, MappingNetwork):
        return {"w_avg": s["w_avg"]}
    return {}


def from_jax(model: nn.Module, params: Mapping, state: Mapping
             ) -> Dict[str, torch.Tensor]:
    """The port's state_dict for ``model`` from the JAX trees. Raises if a
    key of ``model.state_dict()`` is not produced or a produced key is not
    the model's."""
    sd = {}
    for name, mod in model.named_modules():
        local = _local_arrays(mod, _subtree(params, name),
                              _subtree(state, name))
        for k, v in local.items():
            sd[f"{name}.{k}" if name else k] = torch.from_numpy(
                np.array(v, copy=True))
    want = set(model.state_dict())
    if set(sd) != want:
        raise KeyError(f"from_jax: missing {sorted(want - set(sd))[:10]}, "
                       f"unexpected {sorted(set(sd) - want)[:10]}")
    return sd


def load_from_jax(model: PSp, params: Mapping, state: Mapping) -> PSp:
    """Load ``from_jax`` strictly into a ``PSp`` and set its out-of-band
    ``latent_avg`` from ``state``."""
    model.load_state_dict(from_jax(model, params, state), strict=True)
    with torch.no_grad():
        model.latent_avg.copy_(torch.from_numpy(
            np.asarray(state["latent_avg"], dtype=np.float32)))
    return model
