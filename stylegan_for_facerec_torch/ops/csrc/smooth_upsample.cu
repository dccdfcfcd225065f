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
// larger output (5 * numel_in * elem bytes). Design: one thread per input
// pixel reads its clamped 3x3 neighbourhood (neighbouring threads share it
// through L1), computes both vertical phases for the three columns and then
// both horizontal phases, and writes its 2x2 output block. No shared memory
// and no halo copies: the reuse is small and the cache serves it.
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

template <typename T>
__global__ void smooth_upsample_kernel(const T* __restrict__ x,
                                       T* __restrict__ y, int64_t planes,
                                       int h, int w) {
  const int64_t total = planes * h * w;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int j = (int)(idx % w);
    const int64_t t = idx / w;
    const int i = (int)(t % h);
    const int64_t p = t / h;
    const T* xp = x + p * h * w;
    const int rows[3] = {max(i - 1, 0) * w, i * w, min(i + 1, h - 1) * w};
    const int cols[3] = {max(j - 1, 0), j, min(j + 1, w - 1)};
    float ev[3], od[3];  // vertical even / odd phase of each column
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float up = load_f32(xp + rows[0] + cols[k]);
      const float mid = load_f32(xp + rows[1] + cols[k]);
      const float dn = load_f32(xp + rows[2] + cols[k]);
      ev[k] = (up + mid) * 0.5f;
      od[k] = (up + 6.f * mid + dn) * 0.125f;
    }
    const int64_t w2 = 2 * (int64_t)w;
    T* yp = y + p * 4 * (int64_t)h * w + (2 * (int64_t)i) * w2 + 2 * j;
    store_f32(yp, (ev[0] + ev[1]) * 0.5f);
    store_f32(yp + 1, (ev[0] + 6.f * ev[1] + ev[2]) * 0.125f);
    store_f32(yp + w2, (od[0] + od[1]) * 0.5f);
    store_f32(yp + w2 + 1, (od[0] + 6.f * od[1] + od[2]) * 0.125f);
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t planes, int h, int w,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = planes * h * w;
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  smooth_upsample_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), planes, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

// planes = N * C. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_smooth_upsample(const void* x, void* y, long long planes,
                                    int h, int w, int dtype, void* stream) {
  if (planes <= 0 || h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, y, planes, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, y, planes, h, w, s);
  return (int)cudaErrorInvalidValue;
}
