"""Serving export with ``torch.export``, as
``stylegan_for_facerec_tpu/utils/export.py`` does with ``jax.export``: the
eval forward traced into a program with the weights in it and the batch
symbolic, saved as one ``.pt2`` file that a process loads without the
model code.

* ``export_embedder``: face-recognition embedding, images (b, H, W, C)
  -> embeddings (b, E).
* ``export_generator``: StyleGAN2-ADA synthesis z (b, z_dim) -> images
  (b, H, W, 3) with the stored (const) noise.
* ``export_embedder_sharded`` and ``run_sharded``: the embedder over a
  mesh's data axis, the global batch ``data * b``.
* ``export_jittable``: any module or plain function on example inputs;
  the three exports above go through it. (JAX's ``platforms`` has no
  counterpart: a program runs on the device it was traced on.)

Layouts at the artifact's boundary are the JAX package's (NHWC). The
generator reaches kernels B1 and B2 as the ``torch.library`` custom ops
``sgfr::bias_act`` and ``sgfr::smooth_upsample`` (``ops``): they stay
nodes of the graph, run the kernels on the card and the plain versions on
the CPU, and count their launches when a loaded program runs. So a
process that loads an artifact must import this package's ``ops``, which
``load_exported`` does. An artifact runs on the device it was exported
on.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.device import resolve_device

ARTIFACT, SIDECAR = "artifact.pt2", "export.json"
# the largest batch a CUDA export admits: on the card the exporter guards
# the batch to at most 65535 (the grid's y/z limit of a kernel it traces)
_MAX_BATCH = 65535


class _Embed(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(images.permute(0, 3, 1, 2))


class _Generate(nn.Module):
    def __init__(self, model: nn.Module, noise_mode: str):
        super().__init__()
        self.model, self.noise_mode = model, noise_mode

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.model(z, noise_mode=self.noise_mode).permute(0, 2, 3, 1)


class _Function(nn.Module):
    """A plain function as a module: the tensors it reaches (a model it
    closes over) become the program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_jittable(fn, example_args: Sequence[torch.Tensor],
                    dynamic_shapes: Optional[Sequence] = None):
    """``torch.export`` of ``fn(*example_args)`` without autograd, as the
    JAX ``export_jittable`` (``jax.export`` of a jitted function). ``fn``
    is a module or a plain function, which is wrapped in one.
    ``dynamic_shapes`` gives one entry per argument (``{dim:
    torch.export.Dim}`` or None), as ``torch.export.export`` takes them.
    The kernels' ``sgfr::`` custom ops stay nodes of the graph."""
    args = tuple(example_args)
    if not isinstance(fn, nn.Module):
        fn = _Function(fn)
        if dynamic_shapes is not None:     # the wrapper takes ``*args``
            dynamic_shapes = (tuple(dynamic_shapes),)
    with torch.no_grad():
        return torch.export.export(fn, args, dynamic_shapes=dynamic_shapes)


def _export(module: nn.Module, tail, dtype, batch: Optional[int], dev):
    """``export_jittable`` of ``module`` on one input (b, *tail): b
    symbolic (traced at 2, since the exporter specialises sizes 0 and 1)
    unless ``batch`` pins it."""
    x = torch.zeros((2 if batch is None else int(batch), *tail),
                    dtype=dtype, device=dev)
    dynamic = None
    if batch is None:
        dynamic = ({0: torch.export.Dim("batch", min=1, max=_MAX_BATCH)},)
    return export_jittable(module, (x,), dynamic)


def export_embedder(model: nn.Module, *, image_size: int = 112,
                    channels: int = 3, dtype=torch.float32,
                    batch: Optional[int] = None, device: str = "cuda"):
    """``torch.export`` program of an embedding backbone in eval mode:
    images (b, image_size, image_size, channels) of ``dtype`` ->
    embeddings (b, E). The weights are a copy of the model's in ``dtype``
    on ``device``."""
    dev = resolve_device(device)
    m = copy.deepcopy(model).to(dev, dtype).eval()
    return _export(_Embed(m), (image_size, image_size, channels), dtype,
                   batch, dev)


def export_generator(model: nn.Module, *, z_dim: int = 512,
                     dtype=torch.float32, batch: Optional[int] = None,
                     noise_mode: str = "const", device: str = "cuda"):
    """``torch.export`` program of a generator in eval mode: z (b, z_dim)
    -> images (b, H, W, C). ``noise_mode="const"`` (the default) makes it
    a function of z alone, the stored per-layer noise; "random" needs a
    generator and is refused."""
    if noise_mode not in ("const", "none"):
        raise ValueError(f"noise_mode {noise_mode!r}: an exported generator "
                         f"takes const or none (sample z instead)")
    dev = resolve_device(device)
    m = copy.deepcopy(model).to(dev, dtype).eval()
    return _export(_Generate(m, noise_mode), (z_dim,), dtype, batch, dev)


def _avals(specs) -> list:
    """'float32[b,112,112,3]' for each tensor of the graph's inputs or
    outputs, a symbolic size as 'b' (the JAX package's name)."""
    out = []
    for node in specs:
        v = node.meta["val"]
        dims = ",".join(str(d) if isinstance(d, int) else "b"
                        for d in v.shape)
        out.append(f"{str(v.dtype).replace('torch.', '')}[{dims}]")
    return out


def save_exported(exported, path: str, metadata: Optional[dict] = None,
                  fn_name: str = "forward") -> None:
    """``<path>/artifact.pt2`` (``torch.export.save``) and the sidecar
    ``<path>/export.json`` with the JAX package's keys: ``fn_name``,
    ``platforms`` (the device the artifact runs on), ``in_avals`` and
    ``out_avals`` (dtype and shape of each input and output), plus
    ``metadata``."""
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, ARTIFACT))
    graph = exported.graph
    user_inputs = set(exported.graph_signature.user_inputs)
    inputs = [n for n in graph.nodes
              if n.op == "placeholder" and n.name in user_inputs]
    output = next(n for n in graph.nodes if n.op == "output")
    devices = {t.device.type for t in (*exported.state_dict.values(),
                                       *exported.constants.values())
               if torch.is_tensor(t)}
    meta = {"fn_name": fn_name,
            "platforms": sorted(devices) or ["cpu"],
            "in_avals": _avals(inputs),
            "out_avals": _avals(output.args[0])}
    if metadata:
        meta.update(metadata)
    with open(os.path.join(path, SIDECAR), "w") as f:
        json.dump(meta, f, indent=1)


def load_exported(path: str):
    """The ``ExportedProgram`` saved at ``path``; ``.module()(x)`` runs it.
    Imports this package's ``ops`` first so that the custom ops the graph
    calls are registered."""
    from .. import ops  # noqa: F401  (registers the sgfr:: custom ops)

    return torch.export.load(os.path.join(path, ARTIFACT))


def export_embedder_sharded(model: nn.Module, mesh, *, image_size: int = 112,
                            channels: int = 3, dtype=torch.float32,
                            device: str = "cuda"):
    """The multi-GPU serving export, as JAX's ``export_embedder_sharded``:
    the batch is split over ``mesh``'s data axis and the weights are
    replicated, so the global batch is ``data * b`` for any b. A
    ``torch.export`` program carries no shardings, so the artifact is the
    program each rank runs on its b rows (``export_embedder``'s, b
    symbolic), with ``sharded_data`` set to the data-axis size; feed it
    with ``run_sharded``."""
    exported = export_embedder(model, image_size=image_size,
                               channels=channels, dtype=dtype, device=device)
    exported.sharded_data = mesh.shape["data"]
    return exported


def run_sharded(exported, images: torch.Tensor, mesh) -> torch.Tensor:
    """Embeddings (N, E) of the global batch ``images`` (N, H, W, C), N a
    multiple of the data-axis size, on every rank: each rank runs the
    program on its contiguous N / data rows and the embeddings are
    gathered over the data axis."""
    want = getattr(exported, "sharded_data", mesh.shape["data"])
    if want != mesh.shape["data"]:
        raise ValueError(f"program exported for {want} data ranks, mesh "
                         f"has {mesh.shape['data']}")
    with torch.no_grad():
        local = exported.module()(mesh.data.local(images))
        return mesh.data.gather(local)
