// Kernel B2b: the adjoint of kernel B2 (StyleGAN2-ADA smooth 2x upsample),
// i.e. the gradient of B2 with respect to its input, over a contiguous
// NCHW tensor, f32 or bf16, any C and any H, W >= 1:
//   g (N, C, 2H, 2W) -> dx (N, C, H, W).
//
// B2 is separable, and so is its adjoint. Along an axis of input length n,
// input j gathers g[2j - 1 .. 2j + 3] with weights
//   [1, 4, 6, 4, 1] / 8                   inside,
//   [0, 8, 7, 4, 1] / 8  at j = 0        (the replication pad's copies of
//   [1, 4, 7, 0, 0] / 8  at j = n - 1     the edge fold back onto it),
//   [0, 8, 8, 0, 0] / 8  for n = 1.
// That is the inside rule over g with two edge terms standing in for the
// values outside [0, 2n): 4 g[0] + g[1] at -1, g[2n - 1] / 4 at 2n (0 at
// 2n + 1). A thread puts them in place where a compare of its column (or
// row) with the plane's edge says so. The 2-D weights are the product of
// the two axes'.
//
// No TPU kernel: the JAX package differentiates the XLA
// stylegan_for_facerec_tpu/ops/resample.py::smooth_upsample by autodiff;
// the Pallas forward (ops/upfirdn_pallas.py) has no VJP.
// Bound on Hopper: bytes. One read of g (4 * numel_in elements) and one
// write of dx (numel_in), 5 * numel_in * elem bytes, as B2. The work is
// ~6 f32 operations per g element, so the kernel is also short of issue
// slots: the design keeps the instructions per element few.
//
// What the design does about it (the plan comes from
// ops/resample.py::_grad_plan):
// - Polyphase and separable: a thread owns kCols = 4 dx columns of a run of
//   dx rows of one plane, i.e. kG = 8 g columns (16 bytes of bf16, 32 of
//   f32) a row. It walks down the run; dx row i reads g rows 2i - 1 ..
//   2i + 3, three of which the previous row read: the thread carries their
//   vertical partial sum and loads two new g rows a dx row, each once, by
//   16-byte loads, neighbouring lanes on neighbouring addresses, the next
//   row's loads issued before the current row is reduced.
// - Few instructions per element: rows are kept as the loaded 16-byte
//   words and widened to f32 by shifts; a row outside the plane or the run
//   is read clamped into the plane and zeroed by a select, so no branch
//   guards a load; the edge terms replace halo values (one compare a row),
//   not per-element weights.
// - Halo columns (1 left, 2 right of the thread's 8) come from the
//   neighbouring lanes by __shfl_sync: a row of a tile is at most 32 lanes
//   of one warp (128 dx columns). Only a plane wider than a tile is cut
//   into tiles whose edge lanes load their halo (the TILED instance).
// - Small planes: a row of a tile takes 2^lg_nq lanes, so a warp holds
//   several rows' runs, of one plane or of several, and a block 256 >>
//   lg_nq runs; the plan shortens the runs where the grid would leave SMs
//   idle. A thread finds its plane by one multiply-high (common.cuh), no
//   division per element.
// - Arithmetic in f32, both axes' 1/8 applied once at the end, one
//   rounding on store. dx is stored by one 8- (bf16) or 16-byte (f32)
//   store a thread where the rows allow; the scalar instance (VEC false)
//   takes any contiguous g with even H, W (a view at an odd offset, ragged
//   widths) by element.
#include "common.cuh"

namespace {

using sgfr::FastDiv;
using sgfr::Pack;

constexpr int kThreads = 256;  // ops/resample.py::_THREADS
constexpr unsigned kFull = 0xffffffffu;
// g columns a thread reads from a row (16 bytes of bf16, 32 of f32), for
// kG / 2 dx columns: ops/resample.py::_GRAD_COLS
constexpr int kG = 8;
constexpr int kCols = kG / 2;

// The launch plan of ops/resample.py::_grad_plan.
struct GradPlan {
  int h, w;                 // dx's
  unsigned runs;            // planes * runs_per_plane
  unsigned runs_per_plane;  // runs of run_rows dx rows cut each plane
  int run_rows, tile_w, lg_nq;
  FastDiv rpp_div;          // divides by runs_per_plane
};

// One g row as a thread holds it: its kG columns as loaded (16-byte
// words), and the halo columns that no lane of its warp holds (0 unless
// loaded).
template <typename T>
struct GRow {
  static constexpr int kWords = kG * sizeof(T) / 16;
  uint4 raw[kWords];
  float left, right0, right1;
};

// The kG values of a row, in f32.
__device__ __forceinline__ void unpack(const GRow<float>& r, float* e) {
#pragma unroll
  for (int k = 0; k < GRow<float>::kWords; ++k) {
    e[4 * k] = __uint_as_float(r.raw[k].x);
    e[4 * k + 1] = __uint_as_float(r.raw[k].y);
    e[4 * k + 2] = __uint_as_float(r.raw[k].z);
    e[4 * k + 3] = __uint_as_float(r.raw[k].w);
  }
}
__device__ __forceinline__ void unpack(const GRow<__nv_bfloat16>& r,
                                       float* e) {
  const unsigned u[4] = {r.raw[0].x, r.raw[0].y, r.raw[0].z, r.raw[0].w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // element 2k is the low half
    e[2 * k] = __uint_as_float(u[k] << 16);
    e[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// Load the thread's columns gc .. gc + kG - 1 of g row `row` (always a
// row of g: outside the plane or the run the row is clamped into it, and
// `valid` false zeroes what was read). `lim` of the columns are inside the
// plane. A strip that passes the plane's right edge (the scalar path's
// ragged W) holds the edge term there: g[2w - 1] / 4 at column 2w (exact),
// 0 beyond. Halo columns are loaded only at a tile's edge (TILED).
template <typename T, bool VEC, bool TILED>
__device__ __forceinline__ GRow<T> load_row(const T* row, bool valid, int gc,
                                            int lim, bool left_mem,
                                            bool right_mem) {
  constexpr int kWords = GRow<T>::kWords;
  GRow<T> r;
  if (VEC) {
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      r.raw[k] = *reinterpret_cast<const uint4*>(row + gc + k * kG / kWords);
  } else {
    Pack<T, kG> v;
#pragma unroll
    for (int k = 0; k < kG; ++k)
      v.v[k] = k < lim ? row[gc + k]
               : k == lim ? sgfr::from_f32<T>(
                                0.25f * sgfr::to_f32(row[gc + k - 1]))
                          : sgfr::from_f32<T>(0.f);
#pragma unroll
    for (int k = 0; k < kWords; ++k)
      r.raw[k] = reinterpret_cast<const uint4*>(&v)[k];
  }
  r.left = TILED && left_mem ? sgfr::to_f32(row[gc - 1]) : 0.f;
  r.right0 = TILED && right_mem ? sgfr::to_f32(row[gc + kG]) : 0.f;
  r.right1 = TILED && right_mem ? sgfr::to_f32(row[gc + kG + 1]) : 0.f;
  if (!valid) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) r.raw[k] = make_uint4(0u, 0u, 0u, 0u);
    r.left = r.right0 = r.right1 = 0.f;
  }
  return r;
}

// The horizontal adjoint of one g row at the thread's kCols dx columns
// (times 8): out[k] = e[2k] + 4 e[2k + 1] + 6 e[2k + 2] + 4 e[2k + 3] +
// e[2k + 4] over g columns gc - 1 .. gc + kG + 1. At the plane's edges the
// halo takes the edge terms: 4 g[0] + g[1] on the left (left_edge: gc ==
// 0), g[2w - 1] / 4 and 0 on the right (right_edge: the strip ends at the
// plane's edge). All lanes of the warp call it together.
template <typename T>
__device__ __forceinline__ void reduce_row(const GRow<T>& r, bool left_shfl,
                                           bool right_shfl, bool left_edge,
                                           bool right_edge, float* out) {
  float e[kG + 3];
  unpack(r, e + 1);
  const float up = __shfl_up_sync(kFull, e[kG], 1);
  const float dn0 = __shfl_down_sync(kFull, e[1], 1);
  const float dn1 = __shfl_down_sync(kFull, e[2], 1);
  e[0] = left_shfl ? up : left_edge ? 4.f * e[1] + e[2] : r.left;
  e[kG + 1] = right_shfl ? dn0 : right_edge ? 0.25f * e[kG] : r.right0;
  e[kG + 2] = right_shfl ? dn1 : r.right1;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const float* a = e + 2 * k;
    out[k] = (a[0] + a[4]) + 4.f * (a[1] + a[3]) + 6.f * a[2];
  }
}

// At most 64 registers a thread, so four blocks fit an SM in both types:
// the f32 instances otherwise take ~75 and fit three, and measured slower
// at the largest path inputs for it (PERF.md).
template <typename T, bool VEC, bool TILED>
__global__ void __launch_bounds__(kThreads, 4) smooth_upsample_grad_kernel(
    const T* __restrict__ g, T* __restrict__ dx, const GradPlan p) {
  const int h = p.h, w = p.w, h2 = 2 * h, w2 = 2 * w, lg_nq = p.lg_nq;
  const unsigned run = blockIdx.x * (kThreads >> lg_nq) +
                       (threadIdx.x >> lg_nq);
  const int q = threadIdx.x & ((1 << lg_nq) - 1);
  const int c0 = blockIdx.y * p.tile_w;
  const int nq = (min(p.tile_w, w - c0) + kCols - 1) / kCols;
  const bool active = run < p.runs && q < nq;
  // the thread's first dx column and g column; an idle thread reads
  // column 0 of g's first plane and stores nothing
  const int j0 = c0 + kCols * q;
  const int gc = active ? 2 * j0 : 0;
  const int lim = w2 - gc;
  // the neighbouring strips: in the tile, so in the warp (shuffle); in
  // another tile (load); or outside the plane (the edge terms)
  const bool left_shfl = q > 0, right_shfl = q + 1 < nq;
  const bool left_mem = active && !left_shfl && gc > 0;
  const bool right_mem = active && !right_shfl && lim > kG;
  const bool left_edge = gc == 0, right_edge = lim == kG;

  int i0 = 0, rows = 0;  // the run: dx rows i0 .. i0 + rows - 1
  const T* gp = g;
  T* dp = dx;
  if (active) {
    const unsigned plane = p.rpp_div.div(run);
    i0 = (int)(run - plane * p.runs_per_plane) * p.run_rows;
    rows = min(p.run_rows, h - i0);
    gp = g + (size_t)plane * h2 * w2;
    dp = dx + ((size_t)plane * h + i0) * w + j0;
  }
  auto load = [&](int m, bool in_run) {
    return load_row<T, VEC, TILED>(gp + min(max(m, 0), h2 - 1) * w2,
                                   in_run && m >= 0 && m < h2, gc, lim,
                                   left_mem, right_mem);
  };
  auto reduce = [&](const GRow<T>& r, float* out) {
    reduce_row<T>(r, left_shfl, right_shfl, left_edge, right_edge, out);
  };

  // Vertically, dx row i is (h[2i - 1] + 4 h[2i] + 6 h[2i + 1] + 4 h[2i + 2]
  // + h[2i + 3]) / 64 over the g rows reduced horizontally. A thread
  // carries acc = h[2i - 1] + 4 h[2i] + 6 h[2i + 1] and hb = h[2i + 1]. A
  // step loads the next dx row's two new g rows, then reduces its own two
  // (a = h[2i + 2], b = h[2i + 3]), stores (acc + 4 a + b) / 64 and carries
  // hb + 4 a + 6 b and b. As horizontally, edge terms stand in for the
  // rows outside the plane: 4 h[0] + h[1] for h[-1], h[2h - 1] / 4 for
  // h[2h] (h[2h + 1] is 0). The first five g rows are loaded before any is
  // reduced.
  float acc[kCols], hb[kCols];
  GRow<T> c2, c3, n2, n3;
  {
    const bool live = rows > 0;
    const GRow<T> a0 = load(2 * i0 - 1, live), a1 = load(2 * i0, live),
                  a2 = load(2 * i0 + 1, live);
    c2 = load(2 * i0 + 2, live);
    c3 = load(2 * i0 + 3, live);
    float hm1[kCols], h0[kCols];
    reduce(a0, hm1);
    reduce(a1, h0);
    reduce(a2, hb);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      acc[k] = (i0 == 0 ? 4.f * h0[k] + hb[k] : hm1[k]) + 4.f * h0[k] +
               6.f * hb[k];
  }
  auto step = [&](int r, const GRow<T>& ra, const GRow<T>& rb, GRow<T>& na,
                  GRow<T>& nb) {
    const int i = i0 + r;
    na = load(2 * i + 4, r + 1 < rows);
    nb = load(2 * i + 5, r + 1 < rows);
    float a[kCols], b[kCols];
    reduce(ra, a);
    reduce(rb, b);
    if (i == h - 1) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) a[k] = 0.25f * hb[k];
    }
    if (r < rows) {
      Pack<T, kCols> o;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        o.v[k] = sgfr::from_f32<T>((acc[k] + 4.f * a[k] + b[k]) *
                                   (1.f / 64.f));
      T* out = dp + (size_t)r * w;
      if (VEC) {
        *reinterpret_cast<Pack<T, kCols>*>(out) = o;
      } else {
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          if (j0 + k < w) out[k] = o.v[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      acc[k] = hb[k] + 4.f * a[k] + 6.f * b[k];
      hb[k] = b[k];
    }
  };
  // every lane of a warp takes the plan's run_rows steps: the shuffles
  // need them all; a step past a thread's run loads and stores nothing.
  // Two steps an iteration, the row buffers trading places.
  for (int r = 0; r < p.run_rows; r += 2) {
    step(r, c2, c3, n2, n3);
    if (r + 1 < p.run_rows) step(r + 1, n2, n3, c2, c3);
  }
}

template <typename T, bool VEC>
void launch_kernel(const void* g, void* dx, dim3 grid, const GradPlan& p,
                   cudaStream_t stream) {
  if (grid.y > 1)
    smooth_upsample_grad_kernel<T, VEC, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(dx), p);
  else
    smooth_upsample_grad_kernel<T, VEC, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<T*>(dx), p);
}

template <typename T>
int launch(const void* g, void* dx, dim3 grid, int vec, const GradPlan& p,
           cudaStream_t stream) {
  if (vec)
    launch_kernel<T, true>(g, dx, grid, p, stream);
  else
    launch_kernel<T, false>(g, dx, grid, p, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// h, w are the INPUT (dx) height and width, g is (planes, 2h, 2w). dtype:
// 0 = float32, 1 = bfloat16. The rest is the launch plan of
// ops/resample.py::_grad_plan. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sgfr_smooth_upsample_grad(
    const void* g, void* dx, int h, int w, int dtype, unsigned row_blocks,
    unsigned col_tiles, unsigned runs, unsigned runs_per_plane, int run_rows,
    int tile_w, int lg_nq, int vec, unsigned rpp_magic, unsigned rpp_shift,
    void* stream) {
  if (runs == 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GradPlan p{h, w, runs, runs_per_plane, run_rows, tile_w, lg_nq,
                   FastDiv{rpp_magic, rpp_shift}};
  const dim3 grid(row_blocks, col_tiles);
  if (dtype == 0) return launch<float>(g, dx, grid, vec, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, dx, grid, vec, p, s);
  return (int)cudaErrorInvalidValue;
}
