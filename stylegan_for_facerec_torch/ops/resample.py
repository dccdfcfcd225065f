"""StyleGAN2-ADA smooth 2x upsample: nearest x2, replication pad (2,1,2,1),
[1,3,3,1]/8 blur on both axes. NCHW. And its adjoint.

``smooth_upsample`` runs the ``torch.library`` custom op
``sgfr::smooth_upsample``. On a CUDA tensor it launches kernel B2
(``csrc/smooth_upsample.cu``), which replaces the Pallas kernel
``_kernel`` of
``stylegan_for_facerec_tpu/ops/upfirdn_pallas.py::smooth_upsample_pallas``,
and its backward, the op ``sgfr::smooth_upsample_grad``, launches kernel
B2b (``csrc/smooth_upsample_grad.cu``), the adjoint stencil. B2b has no
Pallas twin: the JAX package leaves this gradient to XLA's autodiff of
``ops/resample.py::smooth_upsample``. On a
CPU tensor the same ops run ``smooth_upsample_plain`` (the literal
reference sequence) and ``smooth_upsample_grad_plain`` (its steps
transposed, in reverse order). Both kernels are bound by memory: each
moves 5 * numel_in * elem bytes and never stores the 4x nearest-upsampled
tensor that the plain versions make and pad.

The op is linear, so the adjoint's own backward is the forward again: the
backward of ``sgfr::smooth_upsample_grad`` calls B2, and the pair is
differentiable to any order. Both ops have fake implementations for
``torch.export`` and count their launches inside their CUDA
implementations.

``smooth_downsample`` (replication pad (2, 1), the same FIR, keep every
second sample) has no kernel of its own, as in the JAX package, where it
is XLA: it is plain PyTorch on ``upfirdn2d``'s depthwise passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import build
from .upfirdn2d import make_resample_kernel, upfirdn2d

_K1D = (1.0 / 8, 3.0 / 8, 3.0 / 8, 1.0 / 8)
_K4 = make_resample_kernel((1.0, 3.0, 3.0, 1.0))


def _taps(x: torch.Tensor):
    """The depthwise 1-D blur weights, (C, 1, 4, 1) and (C, 1, 1, 4)."""
    c = x.shape[1]
    k = torch.tensor(_K1D, dtype=x.dtype, device=x.device)
    return (k.reshape(1, 1, 4, 1).expand(c, 1, 4, 1),
            k.reshape(1, 1, 1, 4).expand(c, 1, 1, 4))


def smooth_upsample_plain(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), computed in x's dtype."""
    kv, kh = _taps(x)
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    x = F.pad(x, (2, 1, 2, 1), mode="replicate")
    x = F.conv2d(x, kv, groups=x.shape[1])
    return F.conv2d(x, kh, groups=x.shape[1])


def _fold_replicate_pad(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Adjoint of replication padding (2 before, 1 after) along ``dim``:
    the padded cells' gradients return to the edge cells they copied."""
    n = t.shape[dim] - 3
    lo = t.narrow(dim, 0, 2).sum(dim, keepdim=True)
    hi = t.narrow(dim, n + 2, 1)
    body = t.narrow(dim, 2, n)
    if n == 1:
        return body + lo + hi
    return torch.cat([body.narrow(dim, 0, 1) + lo, body.narrow(dim, 1, n - 2),
                      body.narrow(dim, n - 1, 1) + hi], dim)


def smooth_upsample_grad_plain(g: torch.Tensor) -> torch.Tensor:
    """(N, C, 2H, 2W) -> (N, C, H, W): the adjoint of
    ``smooth_upsample_plain``, computed in g's dtype. Each step of the
    forward transposed, in reverse order: the two valid blurs become
    transposed convolutions, the replication pad folds its copies back onto
    the edges, and the nearest x2 sums each 2x2 block."""
    n, c, h2, w2 = g.shape
    kv, kh = _taps(g)
    g = F.conv_transpose2d(g, kh, groups=c)
    g = F.conv_transpose2d(g, kv, groups=c)
    g = _fold_replicate_pad(_fold_replicate_pad(g, 2), 3)
    return g.reshape(n, c, h2 // 2, 2, w2 // 2, 2).sum(dim=(3, 5))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("smooth_upsample").sgfr_smooth_upsample
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_uint] * 2
                   + [ctypes.c_int, ctypes.c_uint] + [ctypes.c_int] * 6
                   + [ctypes.c_uint] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _grad_entry():
    fn = build.load("smooth_upsample_grad").sgfr_smooth_upsample_grad
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_uint] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_uint] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


_THREADS = 256              # kThreads of smooth_upsample(_grad).cu
_TILE_W = 128               # input columns of a tile
_SMEM_BYTES = 40 * 1024     # a tile's shared memory, under the 48 KB static
_STAGE_MIN_BYTES = 1 << 23  # smaller inputs are not staged
_UNSTAGED_SPLIT = 4         # an unstaged tile may be 1/4 of a pass's rows
_RUN_ROWS = 32              # dx rows a B2b thread walks, at most
_GRAD_COLS = 4              # dx columns of a B2b thread: its kCols


def _ceil_log2(v: int) -> int:
    return (v - 1).bit_length()


def _plan(shape, elem: int, x_ptr: int, y_ptr: int,
          sms: int) -> Dict[str, int]:
    """Kernel B2's launch for a contiguous (N, C, H, W) input on a card of
    ``sms`` SMs; the pointers count only modulo 16.

    A block owns ``tile_rows`` rows of the (N*C*H, W) stack of planes times
    ``tile_w`` columns; grid ``(row_tiles, col_tiles)``. Where a plane has
    at most ``tile_rows`` rows, a tile is whole planes (``tile_rows`` a
    multiple of H); else ``tiles_per_plane`` tiles cut each plane. Threads
    take 8 bytes of columns each (``cols``: 4 bf16 or 2 f32), ``1 <<
    lg_nq`` such groups a row, ``_THREADS >> lg_nq`` rows a pass, up to 4
    passes, fewer where that leaves SMs without two blocks each: down to
    one pass staged, and down to a quarter of one unstaged, where the time
    is latency and more SMs share it.

    ``staged``: the tile's rows go through shared memory in 16-byte
    cp.async chunks, ``1 << lg_chunks`` chunk slots a row, at shared column
    16 / elem of a row of ``pitch`` elements. Only an input of at least
    ``_STAGE_MIN_BYTES`` whose rows all start 16-byte aligned is staged;
    the threads of any other read x directly, which measured as fast or
    faster below that size on the H100 (``PERF.md``). ``vec_store``: every
    output row is 16-byte aligned."""
    n, c, h, w = shape
    planes = n * c
    tile_w = min(w, _TILE_W)
    cols = 8 // elem
    nq = -(-tile_w // cols)
    lg_nq = _ceil_log2(nq)
    rows_per_pass = _THREADS >> lg_nq
    col_tiles = -(-w // tile_w)

    def tiling(budget):
        if h <= budget:
            per = min(budget // h, planes)
            return per * h, 1, -(-planes // per)
        return budget, -(-h // budget), planes * -(-h // budget)

    budget = 4 * rows_per_pass
    staged = (planes * h * w * elem >= _STAGE_MIN_BYTES and x_ptr % 16 == 0
              and w * elem % 16 == 0)
    if staged:
        pad = 16 // elem
        pitch = -(-(pad + cols * nq + 1) // pad) * pad
        budget = min(budget, _SMEM_BYTES // (pitch * elem) - 2)
        least = rows_per_pass
    else:
        pitch = 0
        least = max(1, rows_per_pass // _UNSTAGED_SPLIT)
    while (tiling(budget)[2] * col_tiles < 2 * sms
           and budget // 2 >= least):
        budget //= 2
    tile_rows, tiles_per_plane, row_tiles = tiling(budget)
    if row_tiles >= 2 ** 31 or col_tiles >= 2 ** 16:
        raise ValueError(f"smooth_upsample: {tuple(shape)} is too large "
                         f"for B2")
    return dict(row_tiles=row_tiles, col_tiles=col_tiles,
                tile_rows=tile_rows, tiles_per_plane=tiles_per_plane,
                tile_w=tile_w, cols=cols, lg_nq=lg_nq,
                lg_chunks=_ceil_log2(tile_w * elem // 16) if staged else 0,
                staged=int(staged), pitch=pitch,
                vec_store=int(y_ptr % 16 == 0 and 2 * w * elem % 16 == 0))


@functools.lru_cache(maxsize=256)
def _launch_args(shape, elem: int, x_off: int, y_off: int, sms: int):
    """``_plan`` as the C function's arguments after the dtype."""
    p = _plan(shape, elem, x_off, y_off, sms)
    return (p["row_tiles"], p["col_tiles"], p["tile_rows"],
            p["tiles_per_plane"], p["tile_w"], p["lg_nq"], p["lg_chunks"],
            p["staged"], p["pitch"], p["vec_store"],
            *build.fastdiv(shape[2]))


@functools.lru_cache(maxsize=256)
def _grad_plan(shape, elem: int, g_ptr: int, dx_ptr: int,
               sms: int) -> Tuple[int, ...]:
    """Kernel B2b's launch for dx of ``shape`` (N, C, H, W), g (N, C, 2H,
    2W) contiguous, on a card of ``sms`` SMs; the pointers count only
    modulo 16. Returns the C function's arguments after the dtype:
    ``(row_blocks, col_tiles, runs, runs_per_plane, run_rows, tile_w,
    lg_nq, vec)`` and the (magic, shift) pair of runs_per_plane.

    A thread reads 2 * ``_GRAD_COLS`` g columns a row and writes
    ``_GRAD_COLS`` dx columns of each of a run of up to ``run_rows`` dx
    rows of one plane. A tile is up to 32 such strips of a row (``tile_w``
    dx columns, grid dimension y): a row of a tile is ``1 << lg_nq`` lanes
    of one warp, and a block ``_THREADS >> lg_nq`` runs (grid dimension
    x); ``runs_per_plane`` runs cut each plane. Runs start at
    ``_RUN_ROWS`` rows (or H) and are halved while the grid gives fewer
    than two blocks an SM. ``vec``: g read by 16-byte loads and dx stored
    by one store of the thread's columns, where g's pointer is 16-byte
    aligned, dx's aligned to that store and W a multiple of the columns;
    else by element."""
    n, c, h, w = shape
    planes = n * c
    cols = _GRAD_COLS
    vec = int(g_ptr % 16 == 0 and dx_ptr % (cols * elem) == 0
              and w % cols == 0)
    tile_w = min(w, 32 * cols)
    col_tiles = -(-w // tile_w)
    lg_nq = _ceil_log2(-(-tile_w // cols))
    groups = _THREADS >> lg_nq
    run_rows = min(h, _RUN_ROWS)
    while (-(-planes * -(-h // run_rows) // groups) * col_tiles < 2 * sms
           and run_rows > 1):
        run_rows = -(-run_rows // 2)
    runs_per_plane = -(-h // run_rows)
    runs = planes * runs_per_plane
    if runs >= 2 ** 31 or col_tiles >= 2 ** 16 or 4 * h * w >= 2 ** 31:
        raise ValueError(f"smooth_upsample_grad: dx {tuple(shape)} is too "
                         f"large for B2b")
    return (-(-runs // groups), col_tiles, runs, runs_per_plane, run_rows,
            tile_w, lg_nq, vec, *build.fastdiv(runs_per_plane))


@torch.library.custom_op("sgfr::smooth_upsample", mutates_args=(),
                         device_types="cpu")
def _upsample_op(x: torch.Tensor) -> torch.Tensor:
    """The op ``sgfr::smooth_upsample``: its CPU implementation is the
    plain version; its CUDA implementation launches kernel B2."""
    return smooth_upsample_plain(x)


@_upsample_op.register_kernel("cuda")
def _upsample_cuda(x):
    code = build.check_input("smooth_upsample", x)
    if x.dim() != 4 or x.shape[2] < 1 or x.shape[3] < 1:
        raise ValueError(f"smooth_upsample: needs (N, C, H, W) with H, W >= "
                         f"1, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    y = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return y
    rc = _entry()(x.data_ptr(), y.data_ptr(), n * c, h, w, code,
                  *_launch_args(x.shape, x.element_size(), x.data_ptr() % 16,
                                y.data_ptr() % 16,
                                build.sm_count(x.device.index)),
                  torch.cuda.current_stream(x.device).cuda_stream)
    build.raise_on_error("smooth_upsample", rc)
    smooth_upsample.launches += 1
    return y


@torch.library.custom_op("sgfr::smooth_upsample_grad", mutates_args=(),
                         device_types="cpu")
def _upsample_grad_op(g: torch.Tensor) -> torch.Tensor:
    """The op ``sgfr::smooth_upsample_grad``: its CPU implementation is the
    plain version; its CUDA implementation launches kernel B2b."""
    return smooth_upsample_grad_plain(g)


@_upsample_grad_op.register_kernel("cuda")
def _upsample_grad_cuda(g):
    code = build.check_input("smooth_upsample_grad", g)
    if (g.dim() != 4 or g.shape[2] < 2 or g.shape[3] < 2
            or g.shape[2] % 2 or g.shape[3] % 2):
        raise ValueError(f"smooth_upsample_grad: needs (N, C, 2H, 2W) with "
                         f"H, W >= 1, got {tuple(g.shape)}")
    n, c, h2, w2 = g.shape
    dx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    rc = _grad_entry()(g.data_ptr(), dx.data_ptr(), h2 // 2, w2 // 2, code,
                       *_grad_plan(dx.shape, g.element_size(),
                                   g.data_ptr() % 16, dx.data_ptr() % 16,
                                   build.sm_count(g.device.index)),
                       torch.cuda.current_stream(g.device).cuda_stream)
    build.raise_on_error("smooth_upsample_grad", rc)
    smooth_upsample_grad.launches += 1
    return dx


@_upsample_op.register_fake
def _upsample_fake(x):
    n, c, h, w = x.shape
    return x.new_empty((n, c, 2 * h, 2 * w))


@_upsample_grad_op.register_fake
def _upsample_grad_fake(g):
    n, c, h2, w2 = g.shape
    return g.new_empty((n, c, h2 // 2, w2 // 2))


# the op is linear: B2 and B2b are each other's adjoint, so the pair is
# differentiable to any order
_upsample_op.register_autograd(
    lambda ctx, g: _upsample_grad_op(g.contiguous()))
_upsample_grad_op.register_autograd(
    lambda ctx, gg: _upsample_op(gg.contiguous()))


def smooth_upsample_grad(g: torch.Tensor) -> torch.Tensor:
    """The semantics of ``smooth_upsample_grad_plain``, differentiable:
    the op ``sgfr::smooth_upsample_grad``, kernel B2b on a CUDA tensor
    (contiguous NCHW with even H, W >= 2, f32 or bf16, f32 accumulation),
    the plain version on a CPU one. ``smooth_upsample_grad.launches``
    counts the kernel's launches."""
    build.check_device("smooth_upsample_grad", g)
    return _upsample_grad_op(g)


def smooth_upsample(x: torch.Tensor) -> torch.Tensor:
    """The semantics of ``smooth_upsample_plain``, differentiable: the op
    ``sgfr::smooth_upsample``, kernels B2 forward and B2b backward on a
    CUDA tensor (contiguous NCHW, f32 or bf16, any C, H, W >= 1), the
    plain versions on a CPU one. ``smooth_upsample.launches`` counts B2's
    launches."""
    build.check_device("smooth_upsample", x)
    return _upsample_op(x)


smooth_upsample.launches = 0
smooth_upsample_grad.launches = 0


def smooth_downsample(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, ceil(H / 2), ceil(W / 2)): replication pad
    (2, 1) on both axes, the normalized 4x4 binomial FIR, every second
    sample kept (from the first)."""
    xp = F.pad(x, (2, 1, 2, 1), mode="replicate")
    return upfirdn2d(xp, _K4, down=2)
