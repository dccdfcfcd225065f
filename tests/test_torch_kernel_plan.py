"""The launch plans of kernels B1 and B2, on the CPU.

The wrappers compute each launch in Python (``fused_act._plan``,
``resample._plan``, ``build.fastdiv``); the kernels only follow it. These
tests replay the kernels' index arithmetic in numpy, line for line with
``csrc/bias_act.cu`` and ``csrc/smooth_upsample.cu``, over those plans:
the magic division equals ``//``, B1's blocks cover every element once and
find its channel, B2's tiles and threads write every output pixel once,
read only staged shared memory, and give the plain version's result; and
unaligned or ragged inputs get the scalar paths. Shapes: the ones the
inversion and training paths give the kernels at batch 8 (as
``chip_smoke.py``) and ragged ones.
"""

import functools
import math

import numpy as np
import pytest
import torch

from stylegan_for_facerec_torch.models.stylegan2_ada import channels_for
from stylegan_for_facerec_torch.ops import build, fused_act, resample

ALIGNED = 1 << 20          # a device pointer as the allocator gives it
SMS = 132                  # an H100 SXM's streaming multiprocessors
RES = [2 ** i for i in range(2, 9)]
CH = channels_for(RES)
B1_PATH = [(8, CH[r], r, r) for r in RES]
B2_PATH = ([(8, CH[r], r // 2, r // 2) for r in RES[1:]]
           + [(8, 3, r // 2, r // 2) for r in RES[1:]])
B1_RAGGED = [(3, 5, 7, 9), (8, 512), (2, 3, 1, 1)]
B2_RAGGED = [(2, 3, 1, 1), (1, 2, 1, 7), (2, 5, 3, 9), (1, 64, 130, 66)]


def device_div(n, d):
    """common.cuh's FastDiv::div on uint32 lanes."""
    magic, shift = build.fastdiv(d)
    n = np.asarray(n, dtype=np.uint64)
    t = (n * np.uint64(magic)) >> np.uint64(32)
    return ((t + n) & np.uint64(0xFFFFFFFF)) >> np.uint64(shift)


@pytest.mark.parametrize("kind", ["path", "random"])
def test_fastdiv_equals_floor_division(kind):
    """Divisors: every H*W, C and H the paths give B1 and B2 (and the
    ragged shapes'), or 300 random ones. Numerators up to 2**31 - 1, the
    largest a plane index may be (the plans refuse more); the kernels'
    other numerators are below a chunk (8192) or a tile's rows."""
    rng = np.random.RandomState(0)
    if kind == "path":
        divs = sorted({math.prod(s[2:]) for s in B1_PATH + B1_RAGGED}
                      | {s[1] for s in B1_PATH + B1_RAGGED + B2_PATH}
                      | {s[2] for s in B2_PATH + B2_RAGGED} | {1, 2})
    else:
        divs = [int(v) for v in np.unique(np.concatenate([
            rng.randint(1, 2 ** 31, 200), rng.randint(1, 2 ** 16, 100)]))]
    top = 2 ** 31 - 1
    for d in divs:
        k = rng.randint(0, top // d + 1, 2000).astype(np.int64) * d
        n = np.concatenate([np.arange(1 << 14), rng.randint(0, top, 20000),
                            k, k - 1, k + 1, [top, top - 1]])
        n = n[(n >= 0) & (n <= top)].astype(np.uint64)
        np.testing.assert_array_equal(device_div(n, d), n // np.uint64(d),
                                      err_msg=f"divisor {d}")


def b1_replay(shape, elem, x_ptr, y_ptr=ALIGNED, g_ptr=None, sms=SMS):
    """bias_act.cu's blocks under ``fused_act._plan`` (with ``g_ptr``:
    bias_act_grad.cu's, which reads g beside x and cuts the tensor by the
    same ``plane_span``): (every element covered once, every element's bias
    from its channel)."""
    plan = fused_act._plan(shape, elem, x_ptr, y_ptr, sms,
                           *(() if g_ptr is None else (g_ptr,)))[:4]
    # the pointers matter only to the vector path's alignment checks
    ptrs = ((x_ptr, y_ptr, ALIGNED if g_ptr is None else g_ptr)
            if plan[0] > 1 else None)
    return _b1_replay_plan(shape, elem, plan, ptrs)


@functools.lru_cache(maxsize=None)
def _b1_replay_plan(shape, elem, plan, ptrs):
    vec, packed, per_block, blocks = plan
    hw, c = math.prod(shape[2:]), shape[1]
    planes, chunk = math.prod(shape) // hw, 256 * vec * 4
    count = np.zeros(planes * hw, np.int32)
    chan = np.full(planes * hw, -1, np.int32)
    threads_cover = {}
    for bid in range(blocks):
        if packed:
            plane = bid * per_block
            n = min(per_block, planes - plane) * hw
            base = plane * hw
        else:
            plane = bid // per_block
            off = (bid - plane * per_block) * chunk
            n, base = min(chunk, hw - off), plane * hw + off
        assert 0 < n <= chunk
        if n not in threads_cover:     # (u * 256 + tid) * vec + k, u < 4
            e = (np.arange(0, chunk, vec)[:, None] + np.arange(vec)).ravel()
            threads_cover[n] = np.array_equal(np.sort(e[e < n]), np.arange(n))
        if vec > 1:   # 16-byte loads and stores
            for ptr in ptrs:
                assert (ptr + base * elem) % 16 == 0
        count[base:base + n] += 1
        # packed: each vector's plane; a vector lies in one plane
        p = plane + (device_div(np.arange(n) // vec * vec, hw).astype(
            np.int64) if packed else 0)
        chan[base:base + n] = p - c * device_div(p, c).astype(np.int64)
    assert all(threads_cover.values())
    want = np.repeat(np.arange(planes, dtype=np.int32) % c, hw)
    return bool((count == 1).all()), bool(np.array_equal(chan, want))


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape", B1_PATH + B1_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_b1_blocks_cover_each_element_once_with_its_channel(shape, elem):
    for x_ptr in (ALIGNED, ALIGNED + elem):   # a view at storage offset 1
        assert b1_replay(shape, elem, x_ptr) == (True, True)


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape", B1_PATH + B1_RAGGED,
                         ids=lambda s: "x".join(map(str, s)))
def test_b1b_blocks_cover_each_element_once_with_its_channel(shape, elem):
    """B1b under the plan at both SM counts, all three tensors aligned and
    each of x, g and dx in turn at storage offset 1 (the scalar path).
    Replays are cached by plan: B1b's plan is B1's where the pointers
    agree, and most shapes get one plan at both SM counts."""
    a, off = ALIGNED, ALIGNED + elem
    for sms in (114, 132):
        for x_ptr, g_ptr, dx_ptr in [(a, a, a), (off, a, a), (a, off, a),
                                     (a, a, off)]:
            assert b1_replay(shape, elem, x_ptr, dx_ptr, g_ptr, sms) == (
                True, True)
    assert fused_act._plan(shape, elem, a, a, SMS, off)[0] == 1


def b2_replay(x, elem, x_ptr):
    """smooth_upsample.cu under ``resample._plan`` on an f32 (N, C, H, W)
    array: the output, how often each input pixel's 2x2 output block was
    written, and the plan. Shared memory starts as NaN, so a read of an
    unstaged cell shows in the output."""
    n, c, h, w = x.shape
    p = resample._plan(x.shape, elem, x_ptr, ALIGNED, SMS)
    rows_total = n * c * h
    stack = x.reshape(rows_total, w)
    y = np.full((2 * rows_total, 2 * w), np.nan, np.float32)
    count = np.zeros((rows_total, w), np.int32)
    tr, tpp, tw = p["tile_rows"], p["tiles_per_plane"], p["tile_w"]
    pitch, lg_nq, cols = p["pitch"], p["lg_nq"], p["cols"]
    assert cols * elem == 8
    staged = p["staged"]
    if staged:   # the kernel's pad: 16 bytes of a row before its first column
        pad = 16 // elem
        assert (tr + 2) * pitch * elem <= 48 * 1024
        # shared rows 16-byte aligned for cp.async and read_row
        assert pitch % pad == 0
    else:   # not staged: each thread reads its columns of x, clamped
        pad, pitch = 1, cols * -(-tw // cols) + 2
    tid = np.arange(256)
    for bx in range(p["row_tiles"]):
        for by in range(p["col_tiles"]):
            if tr >= h:
                g0, i0 = bx * tr, 0
                rows = min(tr, rows_total - g0)
            else:
                plane = bx // tpp
                i0 = (bx - plane * tpp) * tr
                g0, rows = plane * h + i0, min(tr, h - i0)
            c0 = by * tw
            cw = min(tw, w - c0)
            up = g0 - 1 if i0 > 0 else g0
            dn = g0 + rows if i0 + rows < h else g0 + rows - 1
            src = [up] + list(range(g0, g0 + rows)) + [dn]
            s = np.full((rows + 2, pitch), np.nan, np.float32)
            if staged:   # 16-byte chunk slot k < n_chunks of each row
                n_chunks = cw * elem // 16
                assert n_chunks * 16 == cw * elem
                assert all((x_ptr + (g * w + c0) * elem) % 16 == 0
                           for g in src)
                assert n_chunks <= 1 << p["lg_chunks"] <= 256
                s[:, pad:pad + cw] = stack[src, c0:c0 + cw]
                # halo columns: the plane's edge copied in shared memory,
                # or the neighbouring tile's column from global memory
                s[:, pad - 1] = s[:, pad] if c0 == 0 else stack[src, c0 - 1]
                s[:, pad + cw] = (s[:, pad + cw - 1] if c0 + cw == w
                                  else stack[src, c0 + cw])
            else:   # row r of s: row g0 + r - 1 of x, columns c0 - 1 + ...
                s[:] = stack[src][:, np.clip(c0 - 1 + np.arange(pitch), 0,
                                             w - 1)]
            # threads: cols columns each, rows lr0, lr0 + rows_per_pass, ...
            nq = -(-cw // cols)
            q = tid & ((1 << lg_nq) - 1)
            lr = (tid >> lg_nq)[:, None] + (256 >> lg_nq) * np.arange(
                -(-rows // (256 >> lg_nq)))[None, :]
            ok = (q[:, None] < nq) & (lr < rows)
            q, lr = np.broadcast_to(q[:, None], lr.shape)[ok], lr[ok]
            j = cols * q
            assert (pad + j + cols < pitch).all()
            i = i0 + lr - h * device_div(i0 + lr, h).astype(np.int64)
            assert ((0 <= i) & (i < h)).all()
            sr = lr + 1
            at = pad + j[:, None] - 1 + np.arange(cols + 2)[None, :]
            a = s[np.where(i == 0, sr, sr - 1)[:, None], at]
            m = s[sr[:, None], at]
            d = s[np.where(i == h - 1, sr, sr + 1)[:, None], at]
            ev = (a + m) * np.float32(0.5)
            od = (a + np.float32(6) * m + d) * np.float32(0.125)
            if p["vec_store"]:   # one 16-byte store into each output row
                full = j + cols <= cw
                for row in (2 * (g0 + lr[full]), 2 * (g0 + lr[full]) + 1):
                    addr = ALIGNED + (row * 2 * w + 2 * (c0 + j[full])) * elem
                    assert (addr % (2 * cols * elem) == 0).all()
            for k in range(cols):
                valid = j + k < cw
                g, col = g0 + lr[valid], c0 + j[valid] + k
                np.add.at(count, (g, col), 1)
                for row, ph in ((2 * g, ev[valid]), (2 * g + 1, od[valid])):
                    y[row, 2 * col] = (ph[:, k] + ph[:, k + 1]) * 0.5
                    y[row, 2 * col + 1] = (ph[:, k] + 6 * ph[:, k + 1]
                                           + ph[:, k + 2]) * 0.125
    return y.reshape(n, c, 2 * h, 2 * w), count, p


# ragged shapes whose rows are 16-byte aligned, which B2 can stage: H past
# a tile's rows, W past a tile's columns, both in f32 and bf16
B2_STAGEABLE = [(1, 64, 130, 136), (2, 64, 67, 72)]
B2_CASES = ([(s, 0, None) for s in B2_PATH]
            + [(s, offset, path)
               for s in B2_RAGGED + [(1, 64, 67, 67)] + B2_STAGEABLE
               for offset in (0, 1) for path in ("staged", "direct")])


@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("shape,offset,path", B2_CASES, ids=lambda v: (
    "x".join(map(str, v)) if isinstance(v, tuple) else str(v)))
def test_b2_tiles_write_each_output_once(shape, offset, path, elem,
                                         monkeypatch):
    """Every input pixel's 2x2 output block is written by exactly one
    thread, from staged cells only, and the replay equals the plain
    version (f32; the sums are the kernel's, in numpy's rounding). Path
    shapes take the plan's own path; ragged ones each path the plan lets
    them take whatever their size: staged (through shared memory) only
    where every row starts 16-byte aligned, else and otherwise straight
    from x, also at storage offset 1."""
    if path is not None:
        monkeypatch.setattr(resample, "_STAGE_MIN_BYTES",
                            0 if path == "staged" else 2 ** 62)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    want = resample.smooth_upsample_plain(torch.from_numpy(x)).numpy()
    got, count, p = b2_replay(x, elem, ALIGNED + offset * elem)
    if path is not None:
        assert p["staged"] == (path == "staged" and offset == 0
                               and shape[3] * elem % 16 == 0)
    assert (count == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_b2_plan_at_the_largest_path_inputs():
    """The largest path input is staged and stores 16 bytes; the C = 3
    image skip at batch 8 still gives every SM two blocks."""
    for elem in (4, 2):
        p = resample._plan((8, 64, 128, 128), elem, ALIGNED, ALIGNED, SMS)
        assert (p["staged"], p["vec_store"], p["tile_w"]) == (1, 1, 128)
        p = resample._plan((8, 3, 128, 128), elem, ALIGNED, ALIGNED, SMS)
        assert p["row_tiles"] * p["col_tiles"] >= 2 * SMS


@pytest.mark.parametrize("elem", [4, 2])
def test_unaligned_or_ragged_inputs_take_the_scalar_path(elem):
    vec = 16 // elem
    def plan(*args):
        return fused_act._plan(*args, SMS)

    assert plan((8, 64, 256, 256), elem, ALIGNED, ALIGNED)[0] == vec
    assert plan((8, 512, 4, 4), elem, ALIGNED, ALIGNED)[0] == vec
    for shape, x_ptr, y_ptr in [((8, 64, 256, 256), ALIGNED + elem, ALIGNED),
                                ((8, 64, 256, 256), ALIGNED, ALIGNED + 8),
                                ((3, 5, 7, 9), ALIGNED, ALIGNED),
                                ((8, 512), ALIGNED, ALIGNED),
                                ((2, 3, 1, 1), ALIGNED, ALIGNED)]:
        assert plan(shape, elem, x_ptr, y_ptr)[0] == 1, shape
    def up(*args):
        return resample._plan(*args, SMS)

    # a view at storage offset 1 is read straight from x, however large
    assert up((8, 64, 128, 128), elem, ALIGNED + elem,
              ALIGNED)["staged"] == 0
    # odd W: rows not 16-byte aligned, read straight from x; output rows of
    # 134 elements stored by element
    p = up((16, 64, 67, 67), elem, ALIGNED, ALIGNED)
    assert (p["staged"], p["vec_store"]) == (0, 0)
    # small inputs are not staged
    p = up((2, 5, 3, 9), elem, ALIGNED, ALIGNED)
    assert (p["staged"], p["vec_store"]) == (0, 0)
    assert up((1, 2, 1, 7), elem, ALIGNED, ALIGNED)["vec_store"] == 0
    assert up((8, 64, 128, 128), elem, ALIGNED, ALIGNED + 8)["vec_store"] == 0


@pytest.mark.parametrize("sms", [114, 132])
def test_plans_fill_the_cards_sms(sms):
    """Both plans size their grids by the SM count they are given (an
    H100 PCIe has 114, an SXM 132): B1 spreads small planes over the
    SMs, and B2's tiles of small inputs give every SM two blocks."""
    for elem in (4, 2):
        _, packed, per_block, blocks = fused_act._plan(
            (8, 512, 4, 4), elem, ALIGNED, ALIGNED, sms)[:4]
        assert (packed, per_block) == (1, -(-4096 // sms))
        assert blocks == -(-4096 // per_block)
        for shape in [(8, 3, 128, 128), (8, 512, 16, 16)]:
            p = resample._plan(shape, elem, ALIGNED, ALIGNED, sms)
            assert p["row_tiles"] * p["col_tiles"] >= 2 * sms
