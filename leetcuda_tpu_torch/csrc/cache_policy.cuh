// Cache element policies shared by the attention kernels that read a KV
// cache (decode_attn.cu, chunk_attn.cu): the stored type, values per 16-byte
// vector, the decode of one vector and of one element, and whether f32
// scales per (row, kv head, position) come along. int8 and e4m3 values are
// exact in bf16 (8 and 4 significant bits), so a kernel may stage them as
// bf16 for a tensor-core product and fold the scales past the dots.
#pragma once

#include <cuda_fp8.h>

#include "common.cuh"

namespace lc {

struct CacheBf16 {
  using T = uint16_t;
  static constexpr int kVec = 8;
  static constexpr bool kScaled = false;
  __device__ static void vec(uint4 w, float f[kVec]) {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(ws[e] << 16);
      f[2 * e + 1] = __uint_as_float(ws[e] & 0xffff0000u);
    }
  }
  __device__ static float one(T x) { return bf16_to_f32(x); }
};

struct CacheInt8 {
  using T = int8_t;
  static constexpr int kVec = 16;
  static constexpr bool kScaled = true;
  __device__ static void vec(uint4 w, float f[kVec]) {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      f[e] = static_cast<float>(
          static_cast<int8_t>((ws[e >> 2] >> (8 * (e & 3))) & 0xffu));
  }
  __device__ static float one(T x) { return static_cast<float>(x); }
};

struct CacheE4m3 {
  using T = uint8_t;
  static constexpr int kVec = 16;
  static constexpr bool kScaled = true;
  __device__ static void vec(uint4 w, float f[kVec]) {
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const auto two = static_cast<__nv_fp8x2_storage_t>(
          (ws[h >> 1] >> (16 * (h & 1))) & 0xffffu);
      const float2 v =
          __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
      f[2 * h] = v.x;
      f[2 * h + 1] = v.y;
    }
  }
  __device__ static float one(T x) {
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
  }
};

}  // namespace lc
