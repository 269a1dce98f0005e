// Element types of the row ops and the merge (row_ops.cu, merge_attn.cu):
// the dtype codes their C entry points take, and conversions through f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace lc {

enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <class T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Element i of a vector of dtype ``dt``, as f32 (a weight of any dtype).
__device__ __forceinline__ float load_any(const void* p, int dt, int i) {
  if (dt == kF16) return __half2float(static_cast<const __half*>(p)[i]);
  if (dt == kBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, int dt, int i, float v) {
  if (dt == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

}  // namespace lc
