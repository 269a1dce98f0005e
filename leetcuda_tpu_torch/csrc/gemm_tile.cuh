// The tile machinery the weight-only quantized matmuls share (wq_matmul.cu,
// w4_matmul.cu): a CTA of four warps computes a BM x BN tile of
// x (M, K) bf16 @ W (K, N), where W arrives as bytes and is converted to
// bf16 on its way into shared memory.
//
// Shared memory per stage:
//   sx[BM][BK + 8]      bf16 (uint16), row m, column k; +8 pads the row so
//                       the A fragments are read without bank conflicts;
//   sw[BK / 2][BN + 8]  bf16x2 (uint32), row kp, column n: the low half is
//                       W[2 kp][n], the high half W[2 kp + 1][n], i.e.
//                       exactly one B-fragment register. BN + 8 = 8 mod 32
//                       banks makes the B fragments conflict-free too.
// Loads go global -> registers first (load_x / load_w), so that the next
// stage's loads are in flight while the tensor cores work on this one.
#pragma once

#include "common.cuh"

namespace lc {

constexpr int kGemmThreads = 128;  // four warps

template <int BM_, int BN_, int BK_, int WARPS_M_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WARPS_M = WARPS_M_;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MT = WM / 16, NT = WN / 8, KS = BK / 16;
  static constexpr int LDX = BK + 8;  // uint16 per sx row
  static constexpr int LDW = BN + 8;  // uint32 per sw row
  static constexpr int XCH = BM * BK / 8 / kGemmThreads;         // uint4 each
  static constexpr int WCH = (BK / 2) * (BN / 8) / kGemmThreads;  // 2 x 8 B
  static_assert(WARPS_M * WARPS_N == 4 && WM % 16 == 0 && WN % 8 == 0,
                "warp tiling");
  static_assert(BK % 16 == 0 && XCH * 8 * kGemmThreads == BM * BK,
                "x chunks per thread");
  static_assert(WCH * 16 * kGemmThreads == BK * BN, "w chunks per thread");
  static_assert(LDW % 32 == 8, "conflict-free B fragments");
};

// This warp's origin (row, column) inside the CTA tile.
template <class T>
__device__ __forceinline__ void warp_origin(int& wm0, int& wn0) {
  const int warp = threadIdx.x >> 5;
  wm0 = (warp / T::WARPS_N) * T::WM;
  wn0 = (warp % T::WARPS_N) * T::WN;
}

// Rows [m0, m0 + BM), columns [k0, k0 + BK) of a row-major bf16 matrix with
// row stride ``ld``, into registers: 8 columns of one row per chunk. Rows
// past M and columns past ``kmax`` read as zeros (ld and kmax are
// multiples of 8, so a chunk lies wholly inside or outside).
template <class T>
__device__ __forceinline__ void load_x(uint4 (&r)[T::XCH],
                                       const uint16_t* __restrict__ x, int M,
                                       int ld, int kmax, int m0, int k0) {
#pragma unroll
  for (int i = 0; i < T::XCH; ++i) {
    const int c = threadIdx.x + i * kGemmThreads;
    const int row = c / (T::BK / 8), col = (c % (T::BK / 8)) * 8;
    r[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + row < M && k0 + col < kmax)
      r[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * ld +
                                             k0 + col);
  }
}

template <class T>
__device__ __forceinline__ void store_x(uint16_t* sx, const uint4 (&r)[T::XCH]) {
#pragma unroll
  for (int i = 0; i < T::XCH; ++i) {
    const int c = threadIdx.x + i * kGemmThreads;
    const int row = c / (T::BK / 8), col = (c % (T::BK / 8)) * 8;
    *reinterpret_cast<uint4*>(sx + row * T::LDX + col) = r[i];
  }
}

// Chunk i of this thread in a (BK x BN) byte tile: rows 2 kp and 2 kp + 1,
// columns [8 n8, 8 n8 + 8).
template <class T>
__device__ __forceinline__ void w_chunk(int i, int& kp, int& n8) {
  const int c = threadIdx.x + i * kGemmThreads;
  kp = c / (T::BN / 8);
  n8 = c % (T::BN / 8);
}

// Rows [k0, k0 + BK), columns [n0, n0 + BN) of a row-major byte matrix with
// ``rows`` (even) rows and N (a multiple of 8) columns, into registers:
// r[i][0] holds 8 bytes of row 2 kp, r[i][1] those of row 2 kp + 1. Out of
// range chunks read as zero bytes.
template <class T>
__device__ __forceinline__ void load_w(uint2 (&r)[T::WCH][2],
                                       const uint8_t* __restrict__ w, int N,
                                       int rows, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < T::WCH; ++i) {
    int kp, n8;
    w_chunk<T>(i, kp, n8);
    const int k = k0 + 2 * kp, n = n0 + 8 * n8;
    r[i][0] = r[i][1] = make_uint2(0u, 0u);
    if (k < rows && n < N) {
      const uint8_t* p = w + (size_t)k * N + n;
      r[i][0] = *reinterpret_cast<const uint2*>(p);
      r[i][1] = *reinterpret_cast<const uint2*>(p + N);
    }
  }
}

// Eight bf16x2 pairs (columns 8 n8 .. 8 n8 + 7 of row kp) into sw.
__device__ __forceinline__ void store_w_pairs(uint32_t* sw, int ldw, int kp,
                                              int n8, const uint32_t v[8]) {
  uint4* p = reinterpret_cast<uint4*>(sw + kp * ldw + n8 * 8);
  p[0] = make_uint4(v[0], v[1], v[2], v[3]);
  p[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// Byte j (0..7) of an 8-byte chunk as a signed value.
__device__ __forceinline__ int byte_s8(uint2 w, int j) {
  const uint32_t word = j < 4 ? w.x : w.y;
  return static_cast<int>(static_cast<int8_t>((word >> (8 * (j & 3))) & 0xffu));
}

// acc += sx (BM x BK) @ sw (BK x BN) for this warp's tile, one mma.sync
// m16n8k16 per (m-tile, n-tile, k-step).
template <class T>
__device__ __forceinline__ void warp_mma(float (&acc)[T::MT][T::NT][4],
                                         const uint16_t* sx,
                                         const uint32_t* sw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int wm0, wn0;
  warp_origin<T>(wm0, wn0);
#pragma unroll
  for (int ks = 0; ks < T::KS; ++ks) {
    uint32_t a[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const uint16_t* p = sx + (wm0 + mt * 16 + g) * T::LDX + ks * 16 + 2 * t;
      a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * T::LDX);
      a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * T::LDX + 8);
    }
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      const uint32_t* q = sw + (ks * 8 + t) * T::LDW + wn0 + nt * 8 + g;
      const uint32_t b[2] = {q[0], q[4 * T::LDW]};
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b);
    }
  }
}

}  // namespace lc
