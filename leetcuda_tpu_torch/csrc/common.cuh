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

// D (16 x 8, f32) += A (16 x 16, bf16, row-major) * B (16 x 8, bf16) on the
// tensor cores. Fragments, lane = 4 * g + t: a0 = A[g][2t, 2t+1], a1 =
// A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]; b0 =
// B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g] (the smaller k in the low half);
// c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of mma_bf16_16816 from a padded bf16 tile in shared
// memory (``lds`` elements a row): ``p`` points at row g, column 2t of the
// 16 x 16 block, as the fragment layout above lays it out.
__device__ __forceinline__ void lds_a(uint32_t a[4], const uint16_t* p,
                                      int lds) {
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * lds);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * lds + 8);
}

// The tiles of the forward attention kernels (flash_fwd.cu, chunk_attn.cu)
// by head dim. A warp's 16 x D f32 accumulator is 128 registers a thread
// at D = 256, so there the Q fragments are read from the q tile in shared
// memory instead of held (64 registers more) and the key tiles hold 32
// keys (half the S registers); the K, V and q tiles then take dynamic
// shared memory (67.6 KB for 64 q rows). Below 256: 64-key static tiles
// and Q in registers (no dynamic shared memory).
__host__ __device__ constexpr int fwd_kv_tile(int D) {
  return D > 128 ? 32 : 64;
}
__host__ __device__ constexpr int fwd_dyn_smem_bytes(int D, int q_rows) {
  return D > 128 ? (2 * fwd_kv_tile(D) + q_rows) * (D + 8) * 2 : 0;
}

// Raise ``kern``'s dynamic shared-memory limit to ``bytes`` on the current
// device, once per device: CUDA keeps the attribute per device context, so
// a flag per process would leave a second device's first launch refused.
// ``done`` is the caller's per-instantiation mask (bit d: set on device d;
// devices past 63 set it on every launch). Returns the CUDA error.
template <class Kern>
inline cudaError_t smem_limit_per_device(Kern kern, int bytes,
                                         unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) done |= bit;
  return e;
}

// The causal band of the attention kernels (flash_fwd.cu, flash_bwd.cu):
// the keys [lo, hi) that q rows [r0, r1) keep, and the q rows [lo, hi) that
// keys [c0, c1) are kept by (none: 0, 0); ``window`` > 0 keeps rows - cols <
// window. attention/flash.py ``key_range`` and attention/flash_bwd.py
// ``row_range`` are the same formulas.
__device__ __forceinline__ void key_range(int r0, int r1, int Nq, int Nk,
                                          int causal, int window, int& lo,
                                          int& hi) {
  r1 = min(r1, Nq);
  lo = r1 <= r0 ? 0 : window > 0 ? max(r0 - window + 1, 0) : 0;
  hi = r1 <= r0 ? 0 : causal ? min(Nk, r1) : Nk;
}
__device__ __forceinline__ void row_range(int c0, int c1, int Nq, int Nk,
                                          int causal, int window, int& lo,
                                          int& hi) {
  c1 = min(c1, Nk);
  lo = c1 <= c0 ? 0 : causal ? c0 : 0;
  hi = c1 <= c0 ? 0 : window > 0 ? min(Nq, c1 - 1 + window) : Nq;
  if (hi < lo) hi = lo;
}

__device__ __forceinline__ bool keep(int row, int col, int Nq, int Nk,
                                     int causal, int window) {
  return row < Nq && col < Nk && (!causal || col <= row) &&
         (window <= 0 || row - col < window);
}

// The epilogue of the split-K matmuls (w4_matmul.cu, wq_matmul.cu): the
// thread holds acc[4 q + 2 h + e] = out[m0 + 8 q + 2 t + e][n + h] for q <
// BM / 8. With one split it writes its part of the tile; otherwise each
// split writes its f32 partial to ``ws`` (splits, M, N) and the CTA that
// finishes last (``counter``, zero at launch and zeroed again by that CTA;
// ``last`` a flag in shared memory) sums the partials in split order: no
// float atomics, the same bits on every call. Columns n and n + 1 are
// scaled by ``sc`` after the sum and rounded to bf16 once. Every thread of
// the CTA calls it.
template <int BM>
__device__ __forceinline__ void store_split_k(
    const float (&acc)[BM / 2], float2 sc, uint16_t* o, float* ws,
    int* counter, int* last, int M, int N, int m0, int n, int t, int sp,
    int splits) {
  if (splits == 1) {
#pragma unroll
    for (int q = 0; q < BM / 8; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * q + 2 * t + e;
        if (m < M && n < N)
          *reinterpret_cast<uint32_t*>(o + (size_t)m * N + n) = pack_bf16x2(
              acc[4 * q + e] * sc.x, acc[4 * q + 2 + e] * sc.y);
      }
    return;
  }
#pragma unroll
  for (int q = 0; q < BM / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * q + 2 * t + e;
      if (m < M && n < N)
        *reinterpret_cast<float2*>(ws + ((size_t)sp * M + m) * N + n) =
            make_float2(acc[4 * q + e], acc[4 * q + 2 + e]);
    }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();  // the other splits' partials before reading them
#pragma unroll
  for (int q = 0; q < BM / 8; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * q + 2 * t + e;
      if (m >= M || n >= N) continue;
      const float* p = ws + (size_t)m * N + n;
      float2 sum = __ldcg(reinterpret_cast<const float2*>(p));
      for (int s = 1; s < splits; ++s) {
        const float2 v =
            __ldcg(reinterpret_cast<const float2*>(p + (size_t)s * M * N));
        sum.x += v.x;
        sum.y += v.y;
      }
      *reinterpret_cast<uint32_t*>(o + (size_t)m * N + n) =
          pack_bf16x2(sum.x * sc.x, sum.y * sc.y);
    }
  if (threadIdx.x == 0) *counter = 0;  // zero again for the next launch
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
