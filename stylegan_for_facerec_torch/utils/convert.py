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
    at its child ``1`` or, after a blur, ``2``, and a ``StyledConv``'s
    at ``activate``;
  * the rosinality generator: ``ModulatedConv2d.weight`` HWIO ->
    (1, O, I, k, k), ``ToRGB.bias`` (3,) -> (1, 3, 1, 1), ``input.input``
    (1, 4, 4, C) -> (1, C, 4, 4), the state's ``noises.noise_{i}``
    (1, r, r, 1) -> (1, 1, r, r), ``NoiseInjection.weight`` as it is;
  * the StyleGAN1 layers (``SynthesisLayer1`` as ``SynthesisLayer``,
    ``ToRGBLayer1`` without an affine) and ``EqualizedConv2d``: HWIO ->
    OIHW;
  * ``SynthesisPrologue.const``: HWC -> CHW;
  * BatchNorm2d and BatchNorm1d ``mean``/``var`` state ->
    ``running_mean``/``running_var`` (plus a zero ``num_batches_tracked``);
  * ``noise_const`` and the mapping network's ``w_avg`` (when it tracks
    one) from state;
  * ``PSpFaceRec.avg_image``: state (H, W, 3) -> buffer (3, H, W);
  * the margin heads of ``models.heads`` and ``models.heads_extra``:
    their parameters and buffers under the JAX names, unchanged (a class
    weight stays (C, D) or (D, C) as it is there; ``SSTPrototype``'s
    queue, cursor and labels from state);
  * the GAC adaptive convs (``models.gac``): ``kernel_base`` (k, k, ic,
    oc) -> (oc, ic, k, k), ``kernel_mask`` (G, k, k, ic, 1) -> (G, 1, ic,
    k, k); ``AttBlock.att_channel`` (G, 1, C, 1, 1) as it is.

``InceptionV3`` is made of ``nn.Conv2d`` and BatchNorm (eps 1e-3) under
torchvision's names; so are the backbone zoo's models (``ResNet``, whose
``fc`` reads a map the JAX package also flattens in (C, H, W) order, so
it is transposed only; ``MobileFaceNet``; ``ResidualAttentionNet``,
``EfficientNet`` and ``GhostNet``, whose head Linear follows a
``Flatten(hw)``; ``EfficientNet``'s ``SamePadConv`` is an ``nn.Conv2d``). A stage-3 backbone thus loads whole (``PSpFaceRec``,
``Backbone``), and ``load_stage3_from_jax`` fills a ``Stage3Trainer``
from the JAX trainer's trees; ``load_stage1_from_jax`` fills a ``Stage1Trainer`` from the JAX
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

from ..models import gac, heads, heads_extra
from ..models.psp import PSp, PSpFaceRec
from ..models.stylegan2 import (ConstantInput, EqualConv2d, EqualLinear,
                                FusedLeakyReLU, ModulatedConv2d,
                                NoiseInjection, ToRGB, _Noises)
from ..nn.layers import Flatten
from ..models.stylegan2_ada import (EqualizedConv2d, FullyConnectedLayer,
                                    MappingNetwork, SynthesisLayer,
                                    SynthesisLayer1, SynthesisPrologue,
                                    ToRGBLayer, ToRGBLayer1)


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
    if isinstance(mod, (heads._Head, heads.AmSoftmax,
                        heads_extra._ClassColumns, heads_extra.ArcNegFace,
                        heads_extra.SSTPrototype)):
        own = [k for k, _ in mod.named_parameters(recurse=False)]
        own += [k for k, _ in mod.named_buffers(recurse=False)]
        return {k: p[k] if k in p else s[k] for k in own}
    if isinstance(mod, nn.modules.batchnorm._BatchNorm):
        return {"weight": p["weight"], "bias": p["bias"],
                "running_mean": s["mean"], "running_var": s["var"],
                "num_batches_tracked": np.asarray(0, dtype=np.int64)}
    if isinstance(mod, nn.PReLU):
        return {"weight": p["weight"]}
    if isinstance(mod, gac.AdaConv2dFaster):
        return {"kernel_base": _oihw(p["kernel_base"]),
                "kernel_mask": np.transpose(np.asarray(p["kernel_mask"]),
                                            (0, 4, 3, 1, 2))}
    if isinstance(mod, gac.AttBlock):
        return {"att_channel": p["att_channel"]}
    if isinstance(mod, (FullyConnectedLayer, EqualLinear)):
        out = {"weight": p["weight"]}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, (EqualConv2d, EqualizedConv2d)):
        out = {"weight": _oihw(p["weight"])}
        if mod.bias is not None:
            out["bias"] = p["bias"]
        return out
    if isinstance(mod, (FusedLeakyReLU, NoiseInjection)):
        return dict(p)
    if isinstance(mod, ModulatedConv2d):
        return {"weight": _oihw(p["weight"])[None]}
    if isinstance(mod, ToRGB):
        return {"bias": np.asarray(p["bias"]).reshape(1, 3, 1, 1)}
    if isinstance(mod, ConstantInput):
        return {"input": np.transpose(np.asarray(p["input"]), (0, 3, 1, 2))}
    if isinstance(mod, _Noises):
        return {k: np.transpose(np.asarray(v), (0, 3, 1, 2))
                for k, v in s.items()}
    if isinstance(mod, (SynthesisLayer, SynthesisLayer1)):
        return {"weight": _oihw(p["weight"]), "bias": p["bias"],
                "noise_strength": p["noise_strength"],
                "noise_const": s["noise_const"]}
    if isinstance(mod, (ToRGBLayer, ToRGBLayer1)):
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


def load_stage2_encoder_from_jax(backbone: PSpFaceRec, tree: Mapping
                                 ) -> None:
    """The stage-2 -> stage-3 handoff from a JAX run directory's tree
    (``utils.checkpoint.read_jax_checkpoint``): its ``params.encoder`` and
    ``state.encoder`` ``input_layer`` and ``body`` into ``backbone``'s
    encoder, strictly; the output layer keeps its own weights. Raises
    ``SystemExit`` when the layouts differ (another depth or mode)."""
    params = tree["params"]["encoder"]
    state = tree.get("state", {}).get("encoder", {})
    for part in ("input_layer", "body"):
        mod = getattr(backbone.encoder, part)
        try:
            mod.load_state_dict(from_jax(mod, params[part],
                                         state.get(part, {})), strict=True)
        except (KeyError, RuntimeError) as e:
            raise SystemExit(f"the stage-2 encoder.{part} does not match "
                             f"the stage-3 backbone (another depth or "
                             f"mode?): {str(e)[:300]}") from e


# -- the inverse: a port state_dict into the JAX package's trees ------------

def _hwio(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


_RULED = (nn.Conv2d, EqualConv2d, EqualizedConv2d, ToRGBLayer, ToRGBLayer1,
          nn.Linear, nn.modules.batchnorm._BatchNorm, nn.PReLU,
          FullyConnectedLayer, EqualLinear, SynthesisLayer, SynthesisLayer1,
          SynthesisPrologue, MappingNetwork, PSpFaceRec)


def _jax_local(mod: nn.Module, get, hw=None):
    """(params, state) that module ``mod`` itself owns in the JAX trees,
    from its own torch tensors (``get(name)``: the array, or None when the
    state_dict lacks it); the inverse of ``_local_arrays``."""
    p, s = {}, {}

    def put(d, key, name, fn=np.asarray):
        v = get(name)
        if v is not None:
            d[key] = fn(v)

    if isinstance(mod, (nn.Conv2d, EqualConv2d, EqualizedConv2d,
                        ToRGBLayer, ToRGBLayer1)):
        put(p, "weight", "weight", _hwio)
        put(p, "bias", "bias")
    elif isinstance(mod, nn.Linear):
        def lin(w):
            w = np.asarray(w)
            if hw is None:
                return w.T
            h, wd = hw
            o = w.shape[0]
            return w.reshape(o, -1, h, wd).transpose(2, 3, 1, 0).reshape(
                -1, o)
        put(p, "weight", "weight", lin)
        put(p, "bias", "bias")
    elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
        put(p, "weight", "weight")
        put(p, "bias", "bias")
        put(s, "mean", "running_mean")
        put(s, "var", "running_var")
    elif isinstance(mod, (nn.PReLU, FullyConnectedLayer, EqualLinear)):
        put(p, "weight", "weight")
        put(p, "bias", "bias")
    elif isinstance(mod, (SynthesisLayer, SynthesisLayer1)):
        put(p, "weight", "weight", _hwio)
        put(p, "bias", "bias")
        put(p, "noise_strength", "noise_strength")
        put(s, "noise_const", "noise_const")
    elif isinstance(mod, SynthesisPrologue):
        put(p, "const", "const", lambda c: np.transpose(c, (1, 2, 0)))
    elif isinstance(mod, MappingNetwork):
        put(s, "w_avg", "w_avg")
    elif isinstance(mod, PSpFaceRec):
        put(s, "avg_image", "avg_image",
            lambda a: np.transpose(a, (1, 2, 0)))
    return p, s


def to_jax(model: nn.Module, state_dict: Mapping = None,
           strict: bool = True) -> Tuple[Dict, Dict]:
    """The JAX package's (params, state) trees of ``model`` (nested dicts
    of numpy arrays), from ``state_dict`` (default: the model's own), key
    for key the inverse of ``from_jax``. A module's tree key is its torch
    name, but a child of an ``nn.ModuleList`` is one dotted key there
    (``styles.3``, ``blocks.0``, ``lin.0``), as the JAX package names them.
    A key of the model that ``state_dict`` lacks raises with ``strict``
    (but ``PSpFaceRec.avg_image``, which reference checkpoints keep out of
    band), else its leaf is left out (as the JAX
    ``from_torch(strict=False)``).
    Covers the convolutional, linear, normalisation and StyleGAN2-ADA
    modules; a module with tensors of its own and no rule here raises."""
    sd = model.state_dict() if state_dict is None else state_dict
    # a PSpFaceRec's avg_image travels outside reference state_dicts
    missing = {k for k in set(model.state_dict()) - set(sd)
               if k.rsplit(".", 1)[-1] != "avg_image"}
    if strict and missing:
        raise KeyError(f"to_jax: missing {sorted(missing)[:10]}")
    maps = _flattened_maps(model)
    params: Dict = {}
    state: Dict = {}

    def place(tree, path, local):
        if not local:
            return
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node.update(local)

    def walk(mod, name, path):
        def get(key):
            v = sd.get(f"{name}.{key}" if name else key)
            return None if v is None else np.asarray(
                v.detach().cpu() if torch.is_tensor(v) else v)

        mine = [k for k, v in mod._parameters.items() if v is not None]
        mine += [k for k, v in mod._buffers.items() if v is not None
                 and k not in mod._non_persistent_buffers_set]
        if mine and not isinstance(mod, _RULED):
            raise ValueError(f"to_jax: no rule for {type(mod).__name__} "
                             f"at {name!r}")
        p, s = _jax_local(mod, get, maps.get(name))
        place(params, path, p)
        place(state, path, s)
        for cname, child in mod.named_children():
            if isinstance(mod, nn.ModuleList) and path:
                cpath = path[:-1] + [f"{path[-1]}.{cname}"]
            else:
                cpath = path + [cname]
            walk(child, f"{name}.{cname}" if name else cname, cpath)

    walk(model, "", [])
    return params, state
