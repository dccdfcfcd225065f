// Pieces shared by kernels B1 (bias_act.cu), B1b (bias_act_grad.cu), B2
// (smooth_upsample.cu) and B2b (smooth_upsample_grad.cu).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace sgfr {

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 by one multiply-high and a
// shift. The host computes the pair (ops/build.py::fastdiv):
//   shift = ceil(log2 d),  magic = floor(2^32 (2^shift - d) / d) + 1
// umulhi(n, magic) <= n, so the sum stays below 2^32.
struct FastDiv {
  unsigned magic;
  unsigned shift;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

// N values of T moved by one load or store of N * sizeof(T) bytes (16 for
// the vector paths); the address must be aligned to that size.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// The elements of a contiguous (planes, hw) tensor that block blockIdx.x of
// kernel B1 or B1b covers under ops/fused_act.py::_plan: [base, base + len),
// beginning in plane `plane`. PACKED: per_block whole planes, per_block * hw
// <= chunk; else chunk blockIdx.x % per_block of one plane. One 32-bit
// divide a block, none per element.
struct PlaneSpan {
  unsigned plane, len;
  size_t base;
};

template <bool PACKED>
__device__ __forceinline__ PlaneSpan plane_span(unsigned planes, unsigned hw,
                                                unsigned per_block,
                                                unsigned chunk) {
  PlaneSpan s;
  if (PACKED) {
    s.plane = blockIdx.x * per_block;
    s.len = min(per_block, planes - s.plane) * hw;
    s.base = (size_t)s.plane * hw;
  } else {
    s.plane = blockIdx.x / per_block;
    const unsigned off = (blockIdx.x - s.plane * per_block) * chunk;
    s.len = min(chunk, hw - off);
    s.base = (size_t)s.plane * hw + off;
  }
  return s;
}

// The bias of plane p of an (N, C, ...) tensor: b[p % C] by multiply-high.
__device__ __forceinline__ float plane_bias(const float* __restrict__ bias,
                                            unsigned p, unsigned c,
                                            FastDiv c_div) {
  return __ldg(bias + (p - c * c_div.div(p)));
}

}  // namespace sgfr
