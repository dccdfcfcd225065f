// Kernel B1: fused bias + leaky ReLU + gain + clamp over a contiguous NCHW
// tensor (or (N, C)), f32 or bf16, any C.
//
//   y = clip(lrelu(x + b[c], slope) * gain, -clamp, clamp)
//
// Replaces the Pallas kernel `_fba_kernel` behind
// stylegan_for_facerec_tpu/ops/fused_act.py::fused_bias_act_pallas.
// Bound on Hopper: bytes. One read of x and one write of y
// (2 * numel * elem bytes); the arithmetic is ~5 f32 operations per element.
// Design: one grid-stride pass, one element per thread per step, math in
// f32, the per-channel bias read through the L1 cache (it is C floats).
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
__global__ void fused_bias_act_kernel(const T* __restrict__ x,
                                      const float* __restrict__ bias,
                                      T* __restrict__ y, int64_t n,
                                      int64_t hw, int c, float slope,
                                      float gain, float clamp) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int ch = (int)((i / hw) % c);
    float v = load_f32(x + i) + __ldg(bias + ch);
    v = (v >= 0.f ? v : v * slope) * gain;
    if (clamp >= 0.f) v = fminf(fmaxf(v, -clamp), clamp);
    store_f32(y + i, v);
  }
}

template <typename T>
int launch(const void* x, const float* bias, void* y, int64_t n, int64_t hw,
           int c, float slope, float gain, float clamp, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // 132 SMs x 16 resident blocks of 256 threads; beyond that the loop strides
  const int64_t max_blocks = 132 * 16;
  if (blocks > max_blocks) blocks = max_blocks;
  fused_bias_act_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), bias, static_cast<T*>(y), n, hw, c, slope,
      gain, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. clamp < 0 means no clamp.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_fused_bias_act(const void* x, const float* bias, void* y,
                                   long long n, long long hw, int c,
                                   int dtype, float slope, float gain,
                                   float clamp, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, bias, y, n, hw, c, slope, gain, clamp, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, bias, y, n, hw, c, slope, gain, clamp, s);
  return (int)cudaErrorInvalidValue;
}
