"""Multi-process data and class parallelism, the port of
``stylegan_for_facerec_tpu/parallel/mesh.py``.

In JAX one process drives a ``Mesh`` of devices with a ``data`` axis (the
batch) and a ``model`` axis (the class-sharded margin head), and XLA puts
in the collectives. In torch one process owns one device, so the mesh is
over ranks: rank ``r`` sits at data index ``r // model`` and model index
``r % model``. Two kinds of process group come with it:

* the **data axis**: the ranks with the rank's model index. They hold the
  same class shard and different slices of the batch; gradients are
  summed over it.
* the **model axis**: the ranks with the rank's data index. They hold the
  same batch slice and different class shards; the margin softmax
  reduces over it (``sharded_head``).

``batch_sharding``/``class_sharded``/``shard_params`` become ``Axis.rows``
(a rank's contiguous slice of a leading dimension) and the trainers'
shards of the ``(num_classes, D)`` head. ``from_process_local`` has no
counterpart: a rank's tensor already is its slice of the global batch.

The collectives are ``torch.distributed`` all-reduce and broadcast only,
which gloo runs on CPU and CUDA tensors and NCCL on CUDA tensors. The
default backend is ``cpu:gloo,cuda:nccl`` (``gloo`` without a card; a
card without NCCL raises): each collective takes the backend of its
tensor's device. A failed initialisation or collective raises.

Gradients follow one rule. Every rank computes the global-batch loss, but
the reduction that makes it (``Axis.mean_share``) hands each rank the
gradient through its own rows only, so the parameter gradients are summed
over the data axis (``Axis.sum_grads_``) and equal one process's gradient
on the concatenated batch. Below that reduction a rank's gradients are
its share: a global statistic that feeds the rank's rows (BatchNorm's
moments, the minibatch stddev's gathered batch, path length's mean) goes
through ``Axis.sum``, whose backward sums the shares.

Every all-reduce and broadcast issued here adds to the counters
``sgfr.collective.calls`` and ``sgfr.collective.bytes`` (the flat
tensor's ``numel x element_size``) of ``utils/tracing.py``.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch.autograd import Function

from ..utils.device import resolve_device
from ..utils.draws import SliceGenerator
from ..utils.tracing import count

_TIMEOUT = datetime.timedelta(seconds=600)


def default_backend() -> str:
    """``cpu:gloo,cuda:nccl`` with a card, ``gloo`` without one. A card
    without NCCL raises: CUDA tensors' collectives would go through the
    host unasked (a caller who wants that passes ``backend="gloo"``)."""
    if not torch.cuda.is_available():
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("this torch has CUDA but no NCCL: pass backend="
                           "'gloo' to run CUDA tensors' collectives through "
                           "the host")
    return "cpu:gloo,cuda:nccl"


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: Optional[str] = None) -> bool:
    """Idempotent ``init_process_group``; returns whether the run has more
    than one process. ``backend`` defaults to ``default_backend()``; the
    two ranks on one card of ``chip_smoke.py`` pass ``gloo`` (NCCL takes
    one rank per device)."""
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(),
                                init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=_TIMEOUT)
    return dist.get_world_size() > 1


def initialize_distributed_from_env(backend: Optional[str] = None) -> bool:
    """Join the run that the environment describes: torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` (and ``LOCAL_RANK``,
    the card this process takes), or the JAX CLI's documented
    ``SGFR_COORDINATOR`` (host:port), ``SGFR_NUM_PROCESSES`` and
    ``SGFR_PROCESS_ID``. Without either it joins nothing. Idempotent;
    returns whether the run has more than one process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if "LOCAL_RANK" in env and torch.cuda.is_available():
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    if "RANK" in env and "WORLD_SIZE" in env:
        return initialize_distributed("env://", int(env["WORLD_SIZE"]),
                                      int(env["RANK"]), backend)
    if env.get("SGFR_COORDINATOR"):
        return initialize_distributed(
            f"tcp://{env['SGFR_COORDINATOR']}",
            int(env["SGFR_NUM_PROCESSES"]), int(env["SGFR_PROCESS_ID"]),
            backend)
    return False


def _counted(t: torch.Tensor) -> torch.Tensor:
    count("sgfr.collective.calls")
    count("sgfr.collective.bytes", t.numel() * t.element_size())
    return t


# -- autograd collectives ---------------------------------------------------

def _reduced(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_counted(y), op=op, group=group)
    return y


class _Sum(Function):
    """Sum over the axis of tensors that are shares of one quantity
    (per-channel sums of each rank's rows): the backward sums the ranks'
    gradients too, and is itself a ``_Sum``, so a double backward works."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Sum.apply(g, ctx.group), None


class _MeanShare(Function):
    """Mean over the axis of per-rank values; the backward gives each rank
    1/size of the (identical) upstream gradient: the gradient through its
    own rows."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        return _reduced(x, group) / size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None


class _SumReplicated(Function):
    """Sum over the axis, for ranks that all backpropagate the same loss
    (the model axis): the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyReplicated(Function):
    """The identity, for an input replicated over the axis whose ranks
    each compute part of its gradient (features against their class
    shard): the backward sums the parts."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _SumReplicated.apply(g, ctx.group), None


def _flat_groups(tensors: Iterable[torch.Tensor]):
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    return by_dtype.values()


class Axis:
    """One axis of the mesh as this rank sees it: its process ``group``,
    ``size``, this rank's ``index`` on it and the global ``ranks`` in
    index order."""

    def __init__(self, group, ranks: List[int], index: int):
        self.group, self.ranks, self.index = group, list(ranks), index
        self.size = len(ranks)

    # -- differentiable ----------------------------------------------------

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return _Sum.apply(x, self.group)

    def mean_share(self, x: torch.Tensor) -> torch.Tensor:
        return _MeanShare.apply(x, self.group, self.size)

    def sum_replicated(self, x: torch.Tensor) -> torch.Tensor:
        return _SumReplicated.apply(x, self.group)

    def copy_replicated(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyReplicated.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The equal slices of the axis concatenated in index order, with
        autograd (an all-reduce of zero-padded slices, exact; bf16 and f16
        travel as f32)."""
        wire = x.float() if x.dtype in (torch.bfloat16, torch.float16) \
            else x
        parts = [wire if i == self.index else torch.zeros_like(wire)
                 for i in range(self.size)]
        return self.sum(torch.cat(parts)).to(x.dtype)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor whose leading dim is the global
        batch."""
        return x[self.rows(x.shape[0])]

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous slice of a leading dim of ``n_global``."""
        if n_global % self.size:
            raise ValueError(f"{n_global} rows do not split over "
                             f"{self.size} ranks")
        n = n_global // self.size
        return slice(self.index * n, (self.index + 1) * n)

    # -- no gradient -------------------------------------------------------

    @torch.no_grad()
    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return _reduced(x, self.group) / self.size

    @torch.no_grad()
    def max(self, x: torch.Tensor) -> torch.Tensor:
        return _reduced(x, self.group, dist.ReduceOp.MAX)

    @torch.no_grad()
    def sum_grads_(self, params: Iterable[torch.Tensor]) -> None:
        """Sum the ``.grad`` of ``params`` over the axis in place, one
        flattened all-reduce per dtype. Every rank must hold gradients for
        the same parameters (the same graph does)."""
        grads = [p.grad for p in params if p.grad is not None]
        for gs in _flat_groups(grads):
            flat = torch._utils._flatten_dense_tensors(gs)
            dist.all_reduce(_counted(flat), group=self.group)
            for g, f in zip(gs, torch._utils._unflatten_dense_tensors(
                    flat, gs)):
                g.copy_(f)

    @torch.no_grad()
    def broadcast_(self, tensors: Iterable[torch.Tensor],
                   src_index: int = 0) -> None:
        """Overwrite ``tensors`` with those of the rank at ``src_index``,
        one flattened broadcast per dtype."""
        for ts in _flat_groups(tensors):
            flat = torch._utils._flatten_dense_tensors(ts)
            dist.broadcast(_counted(flat), src=self.ranks[src_index],
                           group=self.group)
            for t, f in zip(ts, torch._utils._unflatten_dense_tensors(
                    flat, ts)):
                t.copy_(f)


class LocalAxis(Axis):
    """The axis of a run without a mesh: one rank, no process group, every
    collective the identity."""

    def __init__(self):
        super().__init__(None, [0], 0)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    mean_share = sum_replicated = copy_replicated = gather = mean = max = sum


class Mesh:
    """The (data, model) layout of the run's ranks; ``data`` and ``model``
    are this rank's ``Axis`` objects, ``world`` the axis of every rank,
    ``device`` the device of its tensors."""

    def __init__(self, data: int, model: int, device: torch.device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if data * model != world:
            raise ValueError(f"mesh {data}x{model} != {world} processes")
        self.shape = {"data": data, "model": model}
        self.rank, self.device = rank, device
        self.world = Axis(dist.group.WORLD, list(range(world)), rank)
        di, mi = rank // model, rank % model
        # every rank creates every group, in the same order
        for m in range(model):
            ranks = [d * model + m for d in range(data)]
            g = dist.new_group(ranks)
            if m == mi:
                self.data = Axis(g, ranks, di)
        for d in range(data):
            ranks = [d * model + m for m in range(model)]
            g = dist.new_group(ranks)
            if d == di:
                self.model = Axis(g, ranks, mi)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> str:
        return str(dist.get_backend())

    def generator(self, seed: int, device=None) -> SliceGenerator:
        """A generator seeded with ``seed`` whose per-image draws cover the
        global batch, of which this rank keeps its data slice."""
        g = SliceGenerator(device or self.device, self.data.index,
                           self.data.size)
        g.manual_seed(seed)
        return g

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is set on any rank (a host sync)."""
        t = torch.tensor([float(flag)], device=self.device)
        dist.all_reduce(_counted(t), op=dist.ReduceOp.MAX)
        return bool(t.item())


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: str = "cuda") -> Mesh:
    """The mesh of the initialised run (``initialize_distributed*``):
    ``data`` defaults to world // model. ``device`` is the rank's device
    (the card unless the caller asks for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised: "
                           "initialize_distributed_from_env() under "
                           "torchrun, or initialize_distributed(...)")
    if data is None:
        data = dist.get_world_size() // model
    return Mesh(data, model, resolve_device(device))
