// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Tensors cross the C interface as raw pointers; bf16 values are handled as
// their 16-bit patterns (uint16_t) and converted with the intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lc {

// Mask value of the reference kernels (attention/flash.py:42,
// attention/decode.py:35): big-negative instead of -inf, so that
// exp(m_old - m_new) never evaluates -inf - -inf.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float bf16_to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

__device__ __forceinline__ uint16_t f32_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// Two floats as one bf16x2 register: ``lo`` in the low half, the element of
// the smaller column index in an mma fragment.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(f32_to_bf16(lo)) |
         (static_cast<uint32_t>(f32_to_bf16(hi)) << 16);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace lc
