// Weight-only quantized matmul, w8a16, for Hopper: out (M, N) bf16 =
// (x (M, K) bf16 @ W (K, N)) * s (N,), W int8 or e4m3, s f32.
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_w8a16 (_wq_mm_kernel):
// the quantized weight block is cast up right after its load, the product
// accumulates in f32, and the per-output-channel scale is applied once to
// the f32 accumulator before the one rounding to bf16.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes at decode, where
// M = 8 and the weight stream dominates (K=2048, N=11264: 23.1 MB, 6.9 us);
// operations at the ragged admission of 8 x 1536 rows (M=12288, K=5632,
// N=2048: 283 GFLOP, 287 us).
// Design, simple first: one CTA of four warps per BM x BN output tile loops
// over K. The x tile (bf16) and the W tile (1 byte an element) are loaded
// into registers one stage ahead, then W is converted to bf16 on its way
// into shared memory, two k rows per 32-bit word: the B fragments of
// mma.sync m16n8k16 (bf16 in, f32 accumulate) read it directly
// (gemm_tile.cuh). The conversion is exact: |q| <= 127 is a bf16 integer,
// and every e4m3 value is a bf16 value; e4m3 decodes through the hardware
// cvt to f16 (bytes 0x7F and 0xFF are NaN, as the TPU's bit decode makes
// them, core/runtime.py e4m3_bits_to_f32). Two tilings, which the wrapper
// picks by row count (gemm/quant.py DECODE_TILE_MAX_ROWS, from the A/B of
// both in chip_smoke.py): 16 x 64 with 128-deep k steps for decode rows
// (176 CTAs over the fused gate|up N = 11264), 64 x 128 with 32-deep steps
// for prefill. TMA, wgmma and split-K (decode at N = 2048 gives only 32
// CTAs) are later work.
#include <cuda_fp8.h>

#include "gemm_tile.cuh"

namespace {

using Decode = lc::GemmTile<16, 64, 128, 1>;
using Prefill = lc::GemmTile<64, 128, 32, 2>;

// The 8 bytes of one W row chunk as floats.
template <bool kFp8>
__device__ __forceinline__ void bytes_to_f32(uint2 w, float f[8]) {
  if constexpr (kFp8) {
    const uint32_t words[2] = {w.x, w.y};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const auto two = static_cast<__nv_fp8x2_storage_t>(
          (words[h >> 1] >> (16 * (h & 1))) & 0xffffu);
      const float2 v =
          __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3)));
      f[2 * h] = v.x;
      f[2 * h + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = static_cast<float>(lc::byte_s8(w, j));
  }
}

template <class T, bool kFp8>
__device__ __forceinline__ void store_w(uint32_t* sw, const uint2 (&r)[T::WCH][2]) {
#pragma unroll
  for (int i = 0; i < T::WCH; ++i) {
    int kp, n8;
    lc::w_chunk<T>(i, kp, n8);
    float lo[8], hi[8];
    bytes_to_f32<kFp8>(r[i][0], lo);
    bytes_to_f32<kFp8>(r[i][1], hi);
    uint32_t v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = lc::pack_bf16x2(lo[j], hi[j]);
    lc::store_w_pairs(sw, T::LDW, kp, n8, v);
  }
}

template <class T, bool kFp8>
__global__ void __launch_bounds__(lc::kGemmThreads)
wq_mm_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ w,
             const float* __restrict__ s, uint16_t* __restrict__ o, int M,
             int N, int K) {
  __shared__ __align__(16) uint16_t sx[T::BM * T::LDX];
  __shared__ __align__(16) uint32_t sw[(T::BK / 2) * T::LDW];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;

  float acc[T::MT][T::NT][4] = {};
  uint4 xr[T::XCH];
  uint2 wr[T::WCH][2];
  const int nk = (K + T::BK - 1) / T::BK;
  lc::load_x<T>(xr, x, M, K, K, m0, 0);
  lc::load_w<T>(wr, w, N, K, n0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    lc::store_x<T>(sx, xr);
    store_w<T, kFp8>(sw, wr);
    __syncthreads();
    if (kt + 1 < nk) {  // the next stage's loads fly while this one computes
      lc::load_x<T>(xr, x, M, K, K, m0, (kt + 1) * T::BK);
      lc::load_w<T>(wr, w, N, K, n0, (kt + 1) * T::BK);
    }
    lc::warp_mma<T>(acc, sx, sw);
    __syncthreads();  // sx and sw are rewritten by the next stage
  }

  // out = acc * s[col], one rounding to bf16
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int wm0, wn0;
  lc::warp_origin<T>(wm0, wn0);
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = n0 + wn0 + nt * 8 + 2 * t;
    if (col >= N) continue;
    const float s0 = s[col], s1 = s[col + 1];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + wm0 + mt * 16 + g + 8 * i;
        if (row < M)
          *reinterpret_cast<uint32_t*>(o + (size_t)row * N + col) =
              lc::pack_bf16x2(acc[mt][nt][2 * i] * s0,
                              acc[mt][nt][2 * i + 1] * s1);
      }
    }
  }
}

template <class T, bool kFp8>
int launch(const void* x, const void* w, const void* s, void* o, int M, int N,
           int K, cudaStream_t stream) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  wq_mm_kernel<T, kFp8><<<grid, lc::kGemmThreads, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(s), static_cast<uint16_t*>(o), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). ``fp8``
// selects e4m3 weights (else int8), ``decode_tile`` the decode tiling (else
// prefill; the caller picks by M). Needs M > 0, K % 32 == 0, N % 8 == 0
// and 16-byte aligned operands. Launches on ``stream``; does not
// synchronise and allocates nothing.
extern "C" int lc_wq_matmul_bf16(const void* x, const void* w, const void* s,
                                 void* o, int M, int N, int K, int fp8,
                                 int decode_tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (decode_tile)
    return fp8 ? launch<Decode, true>(x, w, s, o, M, N, K, st)
               : launch<Decode, false>(x, w, s, o, M, N, K, st);
  return fp8 ? launch<Prefill, true>(x, w, s, o, M, N, K, st)
             : launch<Prefill, false>(x, w, s, o, M, N, K, st);
}
