// Kernel B2b: the adjoint of kernel B2 (StyleGAN2-ADA smooth 2x upsample),
// i.e. the gradient of B2 with respect to its input, over a contiguous
// NCHW tensor, f32 or bf16, any C and any H, W >= 1:
//   g (N, C, 2H, 2W) -> dx (N, C, H, W).
//
// B2 is separable. Along one axis of input length n, output m reads
//   out[m] = sum_t k[t] * x[clamp(m + t - 2, 0, 2n - 1) / 2],
//   k = [1, 3, 3, 1] / 8 (nearest x2, replication pad (2, 1), blur).
// Its adjoint gathers, for input j, the outputs m in [2j-1, 2j+3] within
// [0, 2n) with weights
//   A[m, j] = sum_t k[t] * [clamp(m + t - 2, 0, 2n - 1) / 2 == j],
// which are [1, 4, 6, 4, 1] / 8 inside and carry the replicated-edge terms
// at j = 0 (sum 2.5), at j = n - 1 (sum 1.5) and for n = 1 with no
// special case. The 2-D adjoint is the product of the two axes' weights:
// a 5x5 gather, accumulated in f32.
//
// No TPU kernel: the JAX package differentiates the XLA
// stylegan_for_facerec_tpu/ops/resample.py::smooth_upsample by autodiff;
// the Pallas forward (ops/upfirdn_pallas.py) has no VJP.
// Bound on Hopper: bytes. One read of g (4 * numel_in elements) and one
// write of dx (numel_in), 5 * numel_in * elem bytes, as B2.
// Design: one thread per input pixel, gathering its 5x5 window of g row by
// row (zero weights skipped, so no out-of-range read); neighbouring
// threads share most of their windows through L1. No shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Weights A[2j - 1 + q, j], q = 0..4, of input j along an axis of length n.
__device__ __forceinline__ void axis_weights(int j, int n, float w[5]) {
  const float k[4] = {0.125f, 0.375f, 0.375f, 0.125f};
  const int n2 = 2 * n;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    const int m = 2 * j - 1 + q;
    float s = 0.f;
    if (m >= 0 && m < n2) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int p = min(max(m + t - 2, 0), n2 - 1);
        if ((p >> 1) == j) s += k[t];
      }
    }
    w[q] = s;
  }
}

template <typename T>
__global__ void smooth_upsample_grad_kernel(const T* __restrict__ g,
                                            T* __restrict__ dx,
                                            int64_t planes, int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t w2 = 2 * (int64_t)w;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = (int)(idx % w);
    const int64_t t = idx / w;
    const int i = (int)(t % h);
    const int64_t p = t / h;
    float wy[5], wx[5];
    axis_weights(i, h, wy);
    axis_weights(j, w, wx);
    const T* gp = g + p * 4 * (int64_t)h * w;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 5; ++a) {
      if (wy[a] == 0.f) continue;
      const T* row = gp + (int64_t)(2 * i - 1 + a) * w2 + (2 * j - 1);
      float r = 0.f;
#pragma unroll
      for (int b = 0; b < 5; ++b) {
        if (wx[b] != 0.f) r += wx[b] * load_f32(row + b);
      }
      acc += wy[a] * r;
    }
    store_f32(dx + idx, acc);
  }
}

template <typename T>
int launch(const void* g, void* dx, int64_t planes, int h, int w,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = planes * h * w;
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  smooth_upsample_grad_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), planes, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// planes = N * C; h, w are the INPUT (dx) height and width, g is
// (planes, 2h, 2w). dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_smooth_upsample_grad(const void* g, void* dx,
                                         long long planes, int h, int w,
                                         int dtype, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, dx, planes, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, dx, planes, h, w, s);
  return (int)cudaErrorInvalidValue;
}
