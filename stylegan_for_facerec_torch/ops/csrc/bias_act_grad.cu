// Kernel B1b: gradient of kernel B1 with respect to its input, over a
// contiguous NCHW tensor (or (N, C)), f32 or bf16, any C and any H * W:
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
//
// What the design does about it: B1's (bias_act.cu), with one more stream.
// - The tensor is read as (planes = N * C, HW) and cut as B1 cuts it
//   (common.cuh's plane_span under ops/fused_act.py::_plan): a chunk of one
//   plane a block, its channel found once; or whole small planes a block,
//   each vector's channel by two multiply-highs. No division per element.
// - Each thread loads kUnroll 16-byte vectors of x and as many of g (128
//   bytes) before it computes and stores any.
// - Vectors only where x, g and dx are all 16-byte aligned and HW is a
//   multiple of the vector width; otherwise the scalar instance, same plan.
// - One block per chunk, no grid-stride loop, no SM count in the source.
// The arithmetic is that of bias_act_grad_plain in the same f32 order, the
// product rounded once, so dx equals the plain version bit for bit.
#include "common.cuh"

namespace {

using sgfr::FastDiv;
using sgfr::Pack;

constexpr int kThreads = 256;  // ops/fused_act.py::_THREADS
constexpr int kUnroll = 4;     // ops/fused_act.py::_UNROLL

template <typename T, int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads) fused_bias_act_grad_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const float* __restrict__ bias, T* __restrict__ dx, unsigned planes,
    unsigned hw, unsigned c, unsigned per_block, FastDiv hw_div,
    FastDiv c_div, float slope, float gain, float slope_gain, float clamp) {
  constexpr unsigned kChunk = kThreads * VEC * kUnroll;
  using V = Pack<T, VEC>;
  const sgfr::PlaneSpan s =
      sgfr::plane_span<PACKED>(planes, hw, per_block, kChunk);
  float b = PACKED ? 0.f : sgfr::plane_bias(bias, s.plane, c, c_div);
  V xv[kUnroll], gv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = (u * kThreads + threadIdx.x) * VEC;
    if (i < s.len) {
      xv[u] = *reinterpret_cast<const V*>(x + s.base + i);
      gv[u] = *reinterpret_cast<const V*>(g + s.base + i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = (u * kThreads + threadIdx.x) * VEC;
    if (i >= s.len) break;
    // a vector lies in one plane: hw % VEC == 0
    if (PACKED) b = sgfr::plane_bias(bias, s.plane + hw_div.div(i), c, c_div);
    V o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float v = sgfr::to_f32(xv[u].v[k]) + b;
      const bool pos = v >= 0.f;
      const float y = (pos ? v : v * slope) * gain;
      float d = pos ? gain : slope_gain;
      if (clamp >= 0.f && !(fabsf(y) < clamp)) d = 0.f;
      o.v[k] = sgfr::from_f32<T>(sgfr::to_f32(gv[u].v[k]) * d);
    }
    *reinterpret_cast<V*>(dx + s.base + i) = o;
  }
}

template <typename T, int VEC>
int launch(int packed, const void* g, const void* x, const float* bias,
           void* dx, unsigned planes, unsigned hw, unsigned c,
           unsigned per_block, unsigned blocks, FastDiv hw_div, FastDiv c_div,
           float slope, float gain, float slope_gain, float clamp,
           cudaStream_t stream) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* dt = static_cast<T*>(dx);
  if (packed)
    fused_bias_act_grad_kernel<T, VEC, true><<<blocks, kThreads, 0, stream>>>(
        gt, xt, bias, dt, planes, hw, c, per_block, hw_div, c_div, slope,
        gain, slope_gain, clamp);
  else
    fused_bias_act_grad_kernel<T, VEC, false><<<blocks, kThreads, 0, stream>>>(
        gt, xt, bias, dt, planes, hw, c, per_block, hw_div, c_div, slope,
        gain, slope_gain, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// The launch plan comes from ops/fused_act.py::_plan, as B1's. dtype: 0 =
// float32, 1 = bfloat16 (g, x and dx share it; the bias is float32); vec: 1
// (scalar) or 16 / elem; packed: per_block counts whole planes (1) or
// chunks of one plane (0); clamp < 0 means no clamp.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_fused_bias_act_grad(
    const void* g, const void* x, const float* bias, void* dx,
    unsigned planes, unsigned hw, unsigned c, int dtype, int vec, int packed,
    unsigned per_block, unsigned blocks, unsigned hw_magic, unsigned hw_shift,
    unsigned c_magic, unsigned c_shift, float slope, float gain,
    float slope_gain, float clamp, void* stream) {
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FastDiv hw_div{hw_magic, hw_shift}, c_div{c_magic, c_shift};
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(packed, g, x, bias, dx, planes, hw, c, per_block,
                            blocks, hw_div, c_div, slope, gain, slope_gain,
                            clamp, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(packed, g, x, bias, dx, planes, hw, c, per_block,
                            blocks, hw_div, c_div, slope, gain, slope_gain,
                            clamp, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(packed, g, x, bias, dx, planes, hw, c,
                                    per_block, blocks, hw_div, c_div, slope,
                                    gain, slope_gain, clamp, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(packed, g, x, bias, dx, planes, hw, c,
                                    per_block, blocks, hw_div, c_div, slope,
                                    gain, slope_gain, clamp, s);
  return (int)cudaErrorInvalidValue;
}
