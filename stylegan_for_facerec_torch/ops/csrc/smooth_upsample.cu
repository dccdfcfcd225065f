// Kernel B2: StyleGAN2-ADA smooth 2x upsample over a contiguous NCHW
// tensor, f32 or bf16, any C and any H, W >= 1:
//   (N, C, H, W) -> (N, C, 2H, 2W) = nearest x2, replication pad (2,1,2,1),
//   [1,3,3,1]/8 blur on both axes.
// As a separable polyphase stencil with clamped (edge-replicated) indices:
//   out[2i]   = (x[i-1] + x[i]) / 2
//   out[2i+1] = (x[i-1] + 6 x[i] + x[i+1]) / 8
//
// Replaces the Pallas kernel `_kernel` behind
// stylegan_for_facerec_tpu/ops/upfirdn_pallas.py::smooth_upsample_pallas.
// Bound on Hopper: bytes. One read of the input and one write of the 4x
// larger output (5 * numel_in * elem bytes); the output is 4/5 of them.
//
// What the design does about it. The planes are stacked into one
// (planes * H, W) image; output row 2g and 2g + 1 come from its row g.
// - A block owns a tile: up to 128 input columns of a run of rows, either
//   rows of one plane or whole small planes packed together (the 4x4 and
//   8x8 inputs, the C = 3 image skip). A large input stages the tile, one
//   clamped halo row above and below and one clamped halo column on each
//   side (the replication pad) in shared memory, the rows by 16-byte
//   cp.async. A halo column inside the tile (the plane's edge) is copied
//   in shared memory after the rows land; one outside it is loaded beside
//   the cp.async.
// - Each thread takes kCols = 8 bytes of input columns of a row (4 bf16 or
//   2 f32), reads their 3 x (kCols + 2) neighbourhood from shared memory,
//   and writes 2 * kCols outputs to each of the two output rows as one
//   16-byte store each, neighbouring threads on neighbouring addresses.
//   Where output rows are not 16-byte aligned (W not a multiple of
//   8 / elem) or the columns pass the tile's ragged edge, it stores
//   scalars.
// - The other inputs are not staged (staged = 0): those under the
//   wrapper's byte threshold, where the staging's barrier and round trip
//   through shared memory cost more than they save (measured on the H100,
//   PERF.md), and those whose rows are not 16-byte aligned (a view at an
//   odd offset, W * elem not a multiple of 16). Each thread reads its
//   3 x (kCols + 2) values from global memory with clamped indices; tiles,
//   thread mapping and stores are the same.
// - No index by division per element: the tile comes from blockIdx with at
//   most one 32-bit divide; a thread's row and columns are shifts of its
//   index; its row within the plane is a multiply-high (common.cuh).
// The launch plan (tile rows, shift counts, staging, shared-memory pitch)
// comes from ops/resample.py::_plan. The arithmetic is that of the
// Pallas kernel: both vertical phases of the three columns, then both
// horizontal phases, in f32, with one rounding on store.
#include "common.cuh"

namespace {

using sgfr::FastDiv;
using sgfr::Pack;

constexpr int kThreads = 256;  // ops/resample.py::_THREADS

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// The values at tile columns j - 1 .. j + N of one staged row (j % N == 0).
template <typename T, int N>
__device__ __forceinline__ void read_row(const T* row, int j,
                                         float v[N + 2]) {
  const Pack<T, N> mid = *reinterpret_cast<const Pack<T, N>*>(row + j);
  v[0] = sgfr::to_f32(row[j - 1]);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k + 1] = sgfr::to_f32(mid.v[k]);
  v[N + 1] = sgfr::to_f32(row[j + N]);
}

// The values at columns c - 1 .. c + N of one row of x, clamped to [0, w).
template <typename T, int N>
__device__ __forceinline__ void read_global(const T* row, int c, int w,
                                            float v[N + 2]) {
#pragma unroll
  for (int k = 0; k < N + 2; ++k)
    v[k] = sgfr::to_f32(__ldg(row + min(max(c - 1 + k, 0), w - 1)));
}

// The launch plan of ops/resample.py::_plan, for one (planes * h, w) stack.
struct Plan {
  long long rows_total;
  int h, w, tile_rows;
  unsigned tiles_per_plane;
  int tile_w, lg_nq, lg_chunks, staged, pitch, vec_store;
  FastDiv h_div;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) smooth_upsample_kernel(
    const T* __restrict__ x, T* __restrict__ y, const Plan p) {
  constexpr int kCols = 8 / sizeof(T);  // ops/resample.py::_plan's cols
  constexpr int pad = 16 / sizeof(T);   // a staged row's first column
  const int h = p.h, w = p.w, tile_rows = p.tile_rows, tile_w = p.tile_w;
  const int lg_nq = p.lg_nq, lg_chunks = p.lg_chunks, pitch = p.pitch;
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);

  // The tile: rows [g0, g0 + rows) of the stack, i0 the first one's row in
  // its plane; columns [c0, c0 + cw).
  long long g0;
  int i0, rows;
  if (tile_rows >= h) {  // whole planes
    g0 = (long long)blockIdx.x * tile_rows;
    i0 = 0;
    rows = (int)min((long long)tile_rows, p.rows_total - g0);
  } else {               // tile_rows rows of one plane
    const unsigned plane = blockIdx.x / p.tiles_per_plane;
    i0 = (int)(blockIdx.x - plane * p.tiles_per_plane) * tile_rows;
    g0 = (long long)plane * h + i0;
    rows = min(tile_rows, h - i0);
  }
  const int c0 = blockIdx.y * tile_w;
  const int cw = min(tile_w, w - c0);
  const long long up = i0 > 0 ? g0 - 1 : g0;  // halo rows, clamped
  const long long dn = i0 + rows < h ? g0 + rows : g0 + rows - 1;

  // Stage rows up, g0 .. g0 + rows - 1, dn as shared rows 0 .. rows + 1,
  // columns c0 .. c0 + cw - 1 at shared columns pad .. pad + cw - 1.
  const bool staged = p.staged;
  if (staged) {
    const int n_chunks = cw * (int)sizeof(T) / 16;
    for (int t = threadIdx.x; (t >> lg_chunks) < rows + 2; t += kThreads) {
      const int r = t >> lg_chunks, k = t & ((1 << lg_chunks) - 1);
      if (k >= n_chunks) continue;
      const long long g = r == 0 ? up : (r == rows + 1 ? dn : g0 + r - 1);
      cp_async16(reinterpret_cast<char*>(s + r * pitch + pad) + 16 * k,
                 reinterpret_cast<const char*>(x + g * w + c0) + 16 * k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // halo columns: outside the tile from global memory now, inside it (the
    // plane's edge, replicated) from the staged rows below
    const bool left_in = c0 == 0, right_in = c0 + cw == w;
    if (!left_in || !right_in) {
      for (int t = threadIdx.x; t < 2 * (rows + 2); t += kThreads) {
        const int r = t >> 1;
        const long long g = r == 0 ? up : (r == rows + 1 ? dn : g0 + r - 1);
        if ((t & 1) && !right_in)
          s[r * pitch + pad + cw] = x[g * w + c0 + cw];
        else if (!(t & 1) && !left_in)
          s[r * pitch + pad - 1] = x[g * w + c0 - 1];
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (left_in || right_in) {
      for (int t = threadIdx.x; t < 2 * (rows + 2); t += kThreads) {
        T* row = s + (t >> 1) * pitch + pad;
        if ((t & 1) && right_in)
          row[cw] = row[cw - 1];
        else if (!(t & 1) && left_in)
          row[-1] = row[0];
      }
      __syncthreads();
    }
  }

  const int nq = (cw + kCols - 1) / kCols;
  const int q = threadIdx.x & ((1 << lg_nq) - 1);
  if (q >= nq) return;
  const int j = kCols * q;  // the thread's first column in the tile
  const int nj = min(kCols, cw - j);
  const bool vector = p.vec_store && nj == kCols;
  for (int lr = threadIdx.x >> lg_nq; lr < rows; lr += kThreads >> lg_nq) {
    const int i = i0 + lr - h * (int)p.h_div.div(i0 + lr);
    const int sr = lr + 1;
    const int su = i == 0 ? sr : sr - 1, sd = i == h - 1 ? sr : sr + 1;
    float a[kCols + 2], m[kCols + 2], d[kCols + 2];
    if (staged) {
      read_row<T, kCols>(s + su * pitch + pad, j, a);
      read_row<T, kCols>(s + sr * pitch + pad, j, m);
      read_row<T, kCols>(s + sd * pitch + pad, j, d);
    } else {  // shared row r is row g0 + r - 1 of the stack
      read_global<T, kCols>(x + (g0 + su - 1) * w, c0 + j, w, a);
      read_global<T, kCols>(x + (g0 + sr - 1) * w, c0 + j, w, m);
      read_global<T, kCols>(x + (g0 + sd - 1) * w, c0 + j, w, d);
    }
    float ev[kCols + 2], od[kCols + 2];  // vertical even / odd phases
#pragma unroll
    for (int k = 0; k < kCols + 2; ++k) {
      ev[k] = (a[k] + m[k]) * 0.5f;
      od[k] = (a[k] + 6.f * m[k] + d[k]) * 0.125f;
    }
    // output rows 2g and 2g + 1, columns 2j .. 2j + 2 kCols - 1
    Pack<T, 2 * kCols> oe, oo;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      oe.v[2 * k] = sgfr::from_f32<T>((ev[k] + ev[k + 1]) * 0.5f);
      oe.v[2 * k + 1] = sgfr::from_f32<T>(
          (ev[k] + 6.f * ev[k + 1] + ev[k + 2]) * 0.125f);
      oo.v[2 * k] = sgfr::from_f32<T>((od[k] + od[k + 1]) * 0.5f);
      oo.v[2 * k + 1] = sgfr::from_f32<T>(
          (od[k] + 6.f * od[k + 1] + od[k + 2]) * 0.125f);
    }
    T* ye = y + (2 * (g0 + lr)) * (2LL * w) + 2 * (c0 + j);
    T* yo = ye + 2LL * w;
    if (vector) {
      *reinterpret_cast<Pack<T, 2 * kCols>*>(ye) = oe;
      *reinterpret_cast<Pack<T, 2 * kCols>*>(yo) = oo;
    } else {
#pragma unroll
      for (int k = 0; k < 2 * kCols; ++k) {
        if (k < 2 * nj) {
          ye[k] = oe.v[k];
          yo[k] = oo.v[k];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, dim3 grid, const Plan& p,
           cudaStream_t stream) {
  const size_t smem = (size_t)(p.tile_rows + 2) * p.pitch * sizeof(T);
  smooth_upsample_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace

// planes = N * C. dtype: 0 = float32, 1 = bfloat16. The rest is the launch
// plan of ops/resample.py::_plan. Returns the cudaError_t of the launch (0
// on success).
extern "C" int sgfr_smooth_upsample(
    const void* x, void* y, long long planes, int h, int w, int dtype,
    unsigned row_tiles, unsigned col_tiles, int tile_rows,
    unsigned tiles_per_plane, int tile_w, int lg_nq, int lg_chunks,
    int staged, int pitch, int vec_store, unsigned h_magic, unsigned h_shift,
    void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{planes * h, h, w, tile_rows, tiles_per_plane, tile_w, lg_nq,
               lg_chunks, staged, pitch, vec_store,
               FastDiv{h_magic, h_shift}};
  const dim3 grid(row_tiles, col_tiles);
  if (dtype == 0) return launch<float>(x, y, grid, p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, grid, p, s);
  return (int)cudaErrorInvalidValue;
}
