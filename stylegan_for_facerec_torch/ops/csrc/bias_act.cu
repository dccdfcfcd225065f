// Kernel B1: fused bias + leaky ReLU + gain + clamp over a contiguous NCHW
// tensor (or (N, C)), f32 or bf16, any C and any H * W.
//
//   y = clip(lrelu(x + b[c], slope) * gain, -clamp, clamp)
//
// Replaces the Pallas kernel `_fba_kernel` behind
// stylegan_for_facerec_tpu/ops/fused_act.py::fused_bias_act_pallas.
// Bound on Hopper: bytes. One read of x and one write of y
// (2 * numel * elem bytes); the arithmetic is ~5 f32 operations per element.
//
// What the design does about it. The tensor is read as (planes = N * C, HW).
// - No division per element: where HW is at least a block's chunk, a block
//   walks one contiguous chunk of one plane; one 32-bit divide by the chunks
//   per plane gives its plane, a multiply-high its channel, and the bias is
//   read once into a register. Where HW is smaller, a block covers whole
//   planes, and each vector finds its plane and channel by multiply-high and
//   shift with host-computed magic numbers (common.cuh).
// - Bytes in flight: each thread loads kUnroll 16-byte vectors (8 bf16 or 4
//   f32 values) before it computes and stores any, 64 bytes a thread, so a
//   resident SM keeps tens of KB of loads outstanding. The vector path needs
//   16-byte aligned x and y and HW a multiple of the vector width; the
//   wrapper (ops/fused_act.py::_plan) checks both and otherwise launches the
//   scalar instance (ragged HW, a view at an odd storage offset).
// - One block per chunk, no grid-stride loop: at the largest path shape a
//   launch is ~4 waves of 256-thread blocks over 132 SMs.
// The arithmetic is unchanged, in f32 with one rounding on store, so the
// output equals the plain version in f32 bit for bit (in bf16: the plain
// version run in f32, rounded once).
#include "common.cuh"

namespace {

using sgfr::FastDiv;
using sgfr::Pack;

constexpr int kThreads = 256;  // ops/fused_act.py::_THREADS
constexpr int kUnroll = 4;     // ops/fused_act.py::_UNROLL

template <typename T, int VEC, bool PACKED>
__global__ void __launch_bounds__(kThreads) fused_bias_act_kernel(
    const T* __restrict__ x, const float* __restrict__ bias,
    T* __restrict__ y, unsigned planes, unsigned hw, unsigned c,
    unsigned per_block, FastDiv hw_div, FastDiv c_div, float slope,
    float gain, float clamp) {
  constexpr unsigned kChunk = kThreads * VEC * kUnroll;
  using V = Pack<T, VEC>;
  const sgfr::PlaneSpan s =
      sgfr::plane_span<PACKED>(planes, hw, per_block, kChunk);
  float b = PACKED ? 0.f : sgfr::plane_bias(bias, s.plane, c, c_div);
  V v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned i = (u * kThreads + threadIdx.x) * VEC;
    if (i < s.len) v[u] = *reinterpret_cast<const V*>(x + s.base + i);
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
      float t = sgfr::to_f32(v[u].v[k]) + b;
      t = (t >= 0.f ? t : t * slope) * gain;
      if (clamp >= 0.f) t = fminf(fmaxf(t, -clamp), clamp);
      o.v[k] = sgfr::from_f32<T>(t);
    }
    *reinterpret_cast<V*>(y + s.base + i) = o;
  }
}

template <typename T, int VEC, bool PACKED>
int launch(const void* x, const float* bias, void* y, unsigned planes,
           unsigned hw, unsigned c, unsigned per_block, unsigned blocks,
           FastDiv hw_div, FastDiv c_div, float slope, float gain,
           float clamp, cudaStream_t stream) {
  fused_bias_act_kernel<T, VEC, PACKED><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), bias, static_cast<T*>(y), planes, hw, c,
      per_block, hw_div, c_div, slope, gain, clamp);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch(int packed, const void* x, const float* bias, void* y,
           unsigned planes, unsigned hw, unsigned c, unsigned per_block,
           unsigned blocks, FastDiv hw_div, FastDiv c_div, float slope,
           float gain, float clamp, cudaStream_t stream) {
  if (packed)
    return launch<T, VEC, true>(x, bias, y, planes, hw, c, per_block, blocks,
                                hw_div, c_div, slope, gain, clamp, stream);
  return launch<T, VEC, false>(x, bias, y, planes, hw, c, per_block, blocks,
                               hw_div, c_div, slope, gain, clamp, stream);
}

}  // namespace

// The launch plan comes from ops/fused_act.py::_plan. dtype: 0 = float32,
// 1 = bfloat16; vec: 1 (scalar) or 16 / elem; packed: per_block counts
// whole planes (1) or chunks of one plane (0); clamp < 0 means no clamp.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sgfr_fused_bias_act(
    const void* x, const float* bias, void* y, unsigned planes, unsigned hw,
    unsigned c, int dtype, int vec, int packed, unsigned per_block,
    unsigned blocks, unsigned hw_magic, unsigned hw_shift, unsigned c_magic,
    unsigned c_shift, float slope, float gain, float clamp, void* stream) {
  if (blocks == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FastDiv hw_div{hw_magic, hw_shift}, c_div{c_magic, c_shift};
  if (dtype == 0 && vec == 4)
    return launch<float, 4>(packed, x, bias, y, planes, hw, c, per_block,
                            blocks, hw_div, c_div, slope, gain, clamp, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(packed, x, bias, y, planes, hw, c, per_block,
                            blocks, hw_div, c_div, slope, gain, clamp, s);
  if (dtype == 1 && vec == 8)
    return launch<__nv_bfloat16, 8>(packed, x, bias, y, planes, hw, c,
                                    per_block, blocks, hw_div, c_div, slope,
                                    gain, clamp, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(packed, x, bias, y, planes, hw, c,
                                    per_block, blocks, hw_div, c_div, slope,
                                    gain, clamp, s);
  return (int)cudaErrorInvalidValue;
}
