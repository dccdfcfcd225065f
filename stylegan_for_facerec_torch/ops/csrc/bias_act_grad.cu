// Kernel B1b: gradient of kernel B1 with respect to its input, over a
// contiguous NCHW tensor (or (N, C)), f32 or bf16, any C:
//
//   v  = x + b[c]
//   y  = (v >= 0 ? v : v * slope) * gain
//   dx = g * (v >= 0 ? gain : slope_gain) * [|y| < clamp]
//
// The clamp mask is strict, as in the Pallas kernel: no gradient passes
// where |y| == clamp. slope_gain is slope * gain, computed once by the
// caller in double precision as the Pallas kernel's trace-time constant is.
//
// Replaces the Pallas kernel `_fba_grad_kernel` behind
// stylegan_for_facerec_tpu/ops/fused_act.py::_fba_bwd (the custom VJP of
// fused_bias_act_pallas). The bias gradient db = sum(dx) is not computed
// here, as the JAX package sums outside its kernel.
// Bound on Hopper: bytes. Reads x and g, writes dx (3 * numel * elem
// bytes, plus the C-float bias); ~8 f32 operations per element.
// Design: as B1, one grid-stride pass, one element per thread per step,
// math in f32, the per-channel bias read through the L1 cache.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void fused_bias_act_grad_kernel(const T* __restrict__ g,
                                           const T* __restrict__ x,
                                           const float* __restrict__ bias,
                                           T* __restrict__ dx, int64_t n,
                                           int64_t hw, int c, float slope,
                                           float gain, float slope_gain,
                                           float clamp) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int ch = (int)((i / hw) % c);
    const float v = load_f32(x + i) + __ldg(bias + ch);
    const bool pos = v >= 0.f;
    const float y = (pos ? v : v * slope) * gain;
    float d = pos ? gain : slope_gain;
    if (clamp >= 0.f && !(fabsf(y) < clamp)) d = 0.f;
    store_f32(dx + i, load_f32(g + i) * d);
  }
}

template <typename T>
int launch(const void* g, const void* x, const float* bias, void* dx,
           int64_t n, int64_t hw, int c, float slope, float gain,
           float slope_gain, float clamp, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  fused_bias_act_grad_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), bias,
      static_cast<T*>(dx), n, hw, c, slope, gain, slope_gain, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (g, x and dx share it; the bias is
// float32). clamp < 0 means no clamp.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_fused_bias_act_grad(const void* g, const void* x,
                                        const float* bias, void* dx,
                                        long long n, long long hw, int c,
                                        int dtype, float slope, float gain,
                                        float slope_gain, float clamp,
                                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(g, x, bias, dx, n, hw, c, slope, gain, slope_gain,
                         clamp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, x, bias, dx, n, hw, c, slope, gain,
                                 slope_gain, clamp, s);
  return (int)cudaErrorInvalidValue;
}
