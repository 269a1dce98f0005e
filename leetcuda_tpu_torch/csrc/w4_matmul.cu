// Weight-only int4 matmul, w4a16, for Hopper: out (M, N) bf16 =
// x (M, K) bf16 @ dequant(packed (K/2, N) int8, scales (K/128, N) f32).
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_w4a16 (_w4_mm_kernel).
// The pack is SPLIT-HALVES (quantize_groupwise_int4): packed byte i holds
// W row i in the low nibble, biased by +8, and row K/2 + i in the high
// nibble, two's complement. Scales are per group of 128 rows and fold past
// each group's dot, as on the TPU: for packed group g, a = x[:, g-cols] @
// lo and b = x[:, K/2 + g-cols] @ hi accumulate in f32, then
// acc += a * s[g] + b * s[g + K/256]. (Folding the scale into bf16 weights
// would round q * s to bf16: a different, lossier function.)
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes at decode
// (M=8, K=2048, N=5632: 6.2 MB, 1.9 us); operations at prefill (M=1024,
// K=5632, N=2048: 23.6 GFLOP, 24 us).
// Design, simple first: the tile machinery of wq_matmul.cu (gemm_tile.cuh),
// with two x tiles (the low and the high half of x's columns) and two
// bf16 weight tiles per stage: the nibbles unpack exactly to bf16 integers
// in [-8, 7] on the way into shared memory. Two mma.sync chains run into
// per-group f32 accumulators, folded into the output accumulator with the
// group's scales at the group's last stage. Two tilings, which the wrapper
// picks by row count (gemm/quant.py DECODE_TILE_MAX_ROWS, from the A/B of
// both in chip_smoke.py): 16 x 64 with whole 128-row groups per stage for
// decode rows, 64 x 64 with 32-row stages for prefill (three accumulators
// of a 32 x 32 warp tile fit the registers). TMA, wgmma and split-K are
// later work.
#include "gemm_tile.cuh"

namespace {

constexpr int kGroup = 128;

using Decode = lc::GemmTile<16, 64, 128, 1>;
using Prefill = lc::GemmTile<64, 64, 32, 2>;
static_assert(kGroup % Decode::BK == 0 && kGroup % Prefill::BK == 0,
              "stages never straddle a group");

// Unpack packed rows 2 kp, 2 kp + 1 into the low-half and high-half bf16
// weight tiles: low nibble (b & 15) - 8, high nibble b >> 4 (arithmetic).
template <class T>
__device__ __forceinline__ void store_w4(uint32_t* sw_lo, uint32_t* sw_hi,
                                         const uint2 (&r)[T::WCH][2]) {
#pragma unroll
  for (int i = 0; i < T::WCH; ++i) {
    int kp, n8;
    lc::w_chunk<T>(i, kp, n8);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int b0 = lc::byte_s8(r[i][0], j), b1 = lc::byte_s8(r[i][1], j);
      lo[j] = lc::pack_bf16x2(static_cast<float>((b0 & 15) - 8),
                              static_cast<float>((b1 & 15) - 8));
      hi[j] = lc::pack_bf16x2(static_cast<float>(b0 >> 4),
                              static_cast<float>(b1 >> 4));
    }
    lc::store_w_pairs(sw_lo, T::LDW, kp, n8, lo);
    lc::store_w_pairs(sw_hi, T::LDW, kp, n8, hi);
  }
}

template <class T>
__global__ void __launch_bounds__(lc::kGemmThreads)
w4_mm_kernel(const uint16_t* __restrict__ x, const uint8_t* __restrict__ packed,
             const float* __restrict__ scales, uint16_t* __restrict__ o, int M,
             int N, int K) {
  __shared__ __align__(16) uint16_t sx_lo[T::BM * T::LDX];
  __shared__ __align__(16) uint16_t sx_hi[T::BM * T::LDX];
  __shared__ __align__(16) uint32_t sw_lo[(T::BK / 2) * T::LDW];
  __shared__ __align__(16) uint32_t sw_hi[(T::BK / 2) * T::LDW];
  const int n0 = blockIdx.x * T::BN, m0 = blockIdx.y * T::BM;
  const int Kh = K / 2, half_groups = Kh / kGroup;
  constexpr int kStagesPerGroup = kGroup / T::BK;

  float acc[T::MT][T::NT][4] = {};
  float a[T::MT][T::NT][4] = {};  // this group's low-half product
  float b[T::MT][T::NT][4] = {};  // this group's high-half product
  uint4 xlo[T::XCH], xhi[T::XCH];
  uint2 wr[T::WCH][2];
  const int nk = Kh / T::BK;
  lc::load_x<T>(xlo, x, M, K, K, m0, 0);
  lc::load_x<T>(xhi, x, M, K, K, m0, Kh);
  lc::load_w<T>(wr, packed, N, Kh, n0, 0);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int wm0, wn0;
  lc::warp_origin<T>(wm0, wn0);
  for (int kt = 0; kt < nk; ++kt) {
    lc::store_x<T>(sx_lo, xlo);
    lc::store_x<T>(sx_hi, xhi);
    store_w4<T>(sw_lo, sw_hi, wr);
    __syncthreads();
    if (kt + 1 < nk) {  // the next stage's loads fly while this one computes
      const int k0 = (kt + 1) * T::BK;
      lc::load_x<T>(xlo, x, M, K, K, m0, k0);
      lc::load_x<T>(xhi, x, M, K, K, m0, Kh + k0);
      lc::load_w<T>(wr, packed, N, Kh, n0, k0);
    }
    lc::warp_mma<T>(a, sx_lo, sw_lo);
    lc::warp_mma<T>(b, sx_hi, sw_hi);
    if ((kt + 1) % kStagesPerGroup == 0) {  // fold the group's scales
      const int grp = kt / kStagesPerGroup;
      const float* s_lo = scales + (size_t)grp * N;
      const float* s_hi = scales + (size_t)(grp + half_groups) * N;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        const bool in = col < N;
        const float sl[2] = {in ? s_lo[col] : 0.f, in ? s_lo[col + 1] : 0.f};
        const float sh[2] = {in ? s_hi[col] : 0.f, in ? s_hi[col + 1] : 0.f};
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += a[mt][nt][e] * sl[e & 1] + b[mt][nt][e] * sh[e & 1];
            a[mt][nt][e] = 0.f;
            b[mt][nt][e] = 0.f;
          }
        }
      }
    }
    __syncthreads();  // the tiles are rewritten by the next stage
  }

  // one rounding to bf16
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = n0 + wn0 + nt * 8 + 2 * t;
    if (col >= N) continue;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = m0 + wm0 + mt * 16 + g + 8 * i;
        if (row < M)
          *reinterpret_cast<uint32_t*>(o + (size_t)row * N + col) =
              lc::pack_bf16x2(acc[mt][nt][2 * i], acc[mt][nt][2 * i + 1]);
      }
    }
  }
}

template <class T>
int launch(const void* x, const void* packed, const void* scales, void* o,
           int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  w4_mm_kernel<T><<<grid, lc::kGemmThreads, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<uint16_t*>(o), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
// ``decode_tile`` selects the decode tiling (else prefill; the caller picks
// by M). Group 128; needs M > 0, K % 256 == 0, N % 8 == 0 and 16-byte
// aligned operands. Launches on ``stream``; does not synchronise and
// allocates nothing.
extern "C" int lc_w4_matmul_bf16(const void* x, const void* packed,
                                 const void* scales, void* o, int M, int N,
                                 int K, int decode_tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (2 * kGroup) || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (decode_tile) return launch<Decode>(x, packed, scales, o, M, N, K, st);
  return launch<Prefill>(x, packed, scales, o, M, N, K, st);
}
