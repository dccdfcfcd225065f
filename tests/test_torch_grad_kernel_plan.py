"""The launch plan of kernel B2b (the smooth-upsample adjoint), on the CPU.

``resample._grad_plan`` computes each launch in Python; the kernel only
follows it. These tests replay ``csrc/smooth_upsample_grad.cu`` line for
line in numpy over that plan, every thread of the grid at once: each
thread's run of rows, the 16-byte g loads and halo loads, the warp
shuffles (lane 0 of ``__shfl_up_sync`` and lane 31 of ``__shfl_down_sync``
read their own value), the edge terms picked by compares, and the stores.
They check that every dx element is written once, that no load leaves
the plane, that every 16-byte load and 8-byte store is aligned, and that
the replayed dx equals ``smooth_upsample_grad_plain`` on f32 input.
Shapes: B2's inputs on the inversion and training paths at batch 8 (as
``chip_smoke.py``) and ragged ones with H = 1 or W = 1 planes, at both SM
counts of an H100, aligned and at storage offset 1.
"""

import functools

import numpy as np
import pytest
import torch

from stylegan_for_facerec_torch.models.stylegan2_ada import channels_for
from stylegan_for_facerec_torch.ops import build, resample

ALIGNED = 1 << 20          # a device pointer as the allocator gives it
RES = [2 ** i for i in range(3, 9)]
CH = channels_for(RES)
# dx shapes (B2's inputs): g is (N, C, 2H, 2W)
PATH = ([(8, CH[r], r // 2, r // 2) for r in RES]
        + [(8, 3, r // 2, r // 2) for r in RES])
RAGGED = [(2, 3, 1, 1), (1, 2, 1, 7), (2, 5, 3, 9), (1, 64, 130, 66),
          (1, 64, 130, 136), (2, 64, 67, 72), (3, 2, 5, 1)]


def device_div(n, d):
    """common.cuh's FastDiv::div on uint32 lanes."""
    magic, shift = build.fastdiv(d)
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(magic)) >> np.uint64(32)
    return ((t + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)


@functools.lru_cache(maxsize=None)
def grad_input(shape):
    """Seeded f32 g for dx of ``shape``, and the plain version's dx."""
    n, c, h, w = shape
    g = np.random.default_rng(h * 1000 + w).standard_normal(
        (n, c, 2 * h, 2 * w), dtype=np.float32)
    want = resample.smooth_upsample_grad_plain(torch.from_numpy(g)).numpy()
    return g, want


def shfl_up(v):
    """``__shfl_up_sync(v, 1)`` over (warps, 32) lanes."""
    return np.concatenate([v[:, :1], v[:, :-1]], axis=1)


def shfl_down(v):
    return np.concatenate([v[:, 1:], v[:, -1:]], axis=1)


def b2b_replay(g, elem, g_ptr, dx_ptr, plan):
    """smooth_upsample_grad.cu under ``plan`` (``resample._grad_plan``'s)
    on an f32 g: (dx, how often each dx element was written)."""
    n, c, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    (row_blocks, col_tiles, runs, rpp, run_rows, tile_w, lg_nq,
     vec) = plan[:8]
    assert plan[8:] == build.fastdiv(rpp)
    cols = resample._GRAD_COLS
    kg = 2 * cols
    assert lg_nq <= 5 and (tile_w % cols == 0 or tile_w == w)
    flat = g.reshape(-1)
    dx = np.full(n * c * h * w, np.nan, np.float32)
    written = []
    # every thread of the grid, as (warps, 32 lanes)
    by, bx, tid = np.meshgrid(np.arange(col_tiles), np.arange(row_blocks),
                              np.arange(256), indexing="ij")
    by, bx, tid = (a.reshape(-1, 32).astype(np.int64) for a in (by, bx, tid))
    run = bx * (256 >> lg_nq) + (tid >> lg_nq)
    q = tid & ((1 << lg_nq) - 1)
    c0 = by * tile_w
    nq = (np.minimum(tile_w, w - c0) + cols - 1) // cols
    active = (run < runs) & (q < nq)
    j0 = c0 + cols * q
    gc = np.where(active, 2 * j0, 0)   # an idle thread reads column 0
    lim = w2 - gc
    left_shfl, right_shfl = q > 0, q + 1 < nq
    left_mem = active & ~left_shfl & (gc > 0)
    right_mem = active & ~right_shfl & (lim > kg)
    left_edge, right_edge = gc == 0, lim == kg
    plane = np.where(active, device_div(np.where(active, run, 0), rpp)
                     .astype(np.int64), 0)
    i0 = np.where(active, (run - plane * rpp) * run_rows, 0)
    rows = np.where(active, np.minimum(run_rows, h - i0), 0)
    assert (rows[active] >= 1).all()
    k = np.arange(kg)

    def take(ok, at):   # g at flat index ``at`` where ok, else 0
        return np.where(ok, flat[np.where(ok, at, 0)], np.float32(0))

    def load_row(m, in_run):
        ok = in_run & (m >= 0) & (m < h2)
        at = (plane * h2 + m) * w2 + gc
        # every thread reads, from its row clamped into the plane: inside g
        read = (plane * h2 + np.clip(m, 0, h2 - 1)) * w2 + gc
        assert read.min() >= 0
        assert (read + np.minimum(lim, kg)).max() <= flat.size
        if vec:     # 16-byte loads, inside the row
            assert (gc + kg <= w2).all() and kg * elem % 16 == 0
            assert ((g_ptr + read * elem) % 16 == 0).all()
            inside = ok[..., None]
        else:
            inside = ok[..., None] & (k < lim[..., None])
        assert (gc[ok & left_mem] >= 1).all()
        assert (gc[ok & right_mem] + kg + 1 < w2).all()
        v = take(inside, at[..., None] + k)
        if not vec:   # the edge term inside a strip past the plane's edge
            edge = ok[..., None] & (k == lim[..., None])
            v = v + np.float32(0.25) * take(edge, at[..., None] + k - 1)
        return (v, take(ok & left_mem, at - 1),
                [take(ok & right_mem, at + kg + d) for d in (0, 1)])

    def reduce_row(row):
        v, left, (r0, r1) = row
        e = ([np.where(left_shfl, shfl_up(v[..., -1]), np.where(
                 left_edge, np.float32(4) * v[..., 0] + v[..., 1], left))]
             + [v[..., t] for t in range(kg)]
             + [np.where(right_shfl, shfl_down(v[..., 0]), np.where(
                 right_edge, np.float32(0.25) * v[..., -1], r0)),
                np.where(right_shfl, shfl_down(v[..., 1]), r1)])
        return np.stack([(e[2 * kk] + e[2 * kk + 4])
                         + np.float32(4) * (e[2 * kk + 1] + e[2 * kk + 3])
                         + np.float32(6) * e[2 * kk + 2]
                         for kk in range(cols)], axis=-1)

    live = rows > 0
    rows_in = [load_row(2 * i0 + d, live) for d in range(-1, 4)]
    hm1, h0, hb = (reduce_row(row) for row in rows_in[:3])
    four, six = np.float32(4), np.float32(6)
    acc = (np.where((i0 == 0)[..., None], four * h0 + hb, hm1) + four * h0
           + six * hb)
    c2, c3 = rows_in[3:]
    for r in range(run_rows):
        i = i0 + r
        n2 = load_row(2 * i + 4, r + 1 < rows)
        n3 = load_row(2 * i + 5, r + 1 < rows)
        a, b = reduce_row(c2), reduce_row(c3)
        a = np.where((i == h - 1)[..., None], np.float32(0.25) * hb, a)
        st = r < rows
        o = ((acc + four * a + b) * np.float32(1 / 64)).astype(np.float32)
        base = (plane * h + i) * w + j0
        if vec:   # one store of the thread's columns, inside the row
            assert ((dx_ptr + base[st] * elem) % (cols * elem) == 0).all()
            assert (j0[st] + cols <= w).all()
        for kk in range(cols):
            m = st & (j0 + kk < w)
            written.append(base[m] + kk)
            dx[base[m] + kk] = o[..., kk][m]
        acc, hb = hb + four * a + six * b, b
        c2, c3 = n2, n3
    count = np.bincount(np.concatenate(written), minlength=dx.size)
    return dx.reshape(n, c, h, w), count


@functools.lru_cache(maxsize=None)
def replay_checks(shape, elem, g_ptr, dx_ptr, plan):
    """Whether every dx element was written once, and the replay's largest
    error against the plain version beyond its tolerance (<= 0 passes).
    Cached by plan: the two SM counts often give the same one."""
    g, want = grad_input(shape)
    got, count = b2b_replay(g, elem, g_ptr, dx_ptr, plan)
    excess = np.abs(got - want) - (1e-5 + 1e-5 * np.abs(want))
    return bool((count == 1).all()), float(np.nan_to_num(excess, nan=1.0)
                                           .max())


CASES = ([(s, 0) for s in PATH] + [(s, off) for s in RAGGED
                                   for off in (0, 1)])


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape,offset", CASES, ids=lambda v: (
    "x".join(map(str, v)) if isinstance(v, tuple) else str(v)))
def test_b2b_threads_write_each_dx_once(shape, offset, elem, sms):
    """Every dx element is written by exactly one thread, and the replay
    equals the plain adjoint (f32; the kernel's sums, in numpy's rounding).
    Path shapes take the plan's vector path; the ragged ones, aligned and
    at storage offset 1 of g, the paths their widths and pointers allow."""
    g_ptr = ALIGNED + offset * elem
    plan = resample._grad_plan(shape, elem, g_ptr % 16, ALIGNED % 16, sms)
    once, excess = replay_checks(shape, elem, g_ptr, ALIGNED, plan)
    assert once
    assert excess <= 0
    if shape in PATH:
        assert plan[7] == 1
    if offset:
        assert plan[7] == 0


@pytest.mark.parametrize("elem", [4, 2])
def test_b2b_plan_paths_and_grid(elem):
    """Vectors only where g is 16-byte aligned, dx aligned to a thread's
    store of 4 columns and W a multiple of 4; a row of the largest input
    is one warp's; the grid gives every SM two blocks where the rows allow,
    and runs stay whole at the largest inputs."""
    plan = resample._grad_plan
    for sms in (114, 132):
        p = plan((8, 64, 128, 128), elem, 0, 0, sms)
        assert p[7] == 1 and p[4] >= resample._RUN_ROWS // 2
        assert (p[1], p[5], p[6]) == (1, 128, 5)
        for shape in PATH:
            p = plan(shape, elem, 0, 0, sms)
            assert p[0] * p[1] >= 2 * sms or p[4] == 1
    assert plan((8, 64, 128, 128), elem, elem, 0, 132)[7] == 0
    assert plan((8, 64, 128, 128), elem, 0, 2 * elem, 132)[7] == 0
    assert plan((8, 64, 128, 128), elem, 0, 4 * elem, 132)[7] == 1
    assert plan((2, 5, 3, 9), elem, 0, 0, 132)[7] == 0
    assert plan((3, 2, 5, 1), elem, 0, 0, 132)[7] == 0
