// Exact int8 matmul for Hopper: out (M, N) int32 = x (M, K) int8 @
// w (K, N) int8, summed in int32 (exact: |sum| <= K * 128^2 < 2^31 for
// K < 2^17).
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_i8i8i32 (_i8_mm_kernel),
// the registry's hgemm_w8a8_i32 (atol 0).
//
// Bound on an H100 SXM: operations, at 1979 TOP/s int8 on the tensor cores
// (8192^3: 1.1 TOP, 0.56 ms). Design, simple first: one CTA of eight warps
// per 128 x 128 output tile loops over K in 64-deep steps, with mma.sync
// m16n8k32 s8.s8.s32. The B fragments want four consecutive k of one column
// in a register, but w is (K, N) row-major; so each thread loads a 4 x 4
// block of w (four rows, 4 bytes each), transposes it in registers with
// __byte_perm, and stores four k-contiguous words into shared memory, laid
// out [n][k]. The next step's x and w tiles load into registers while the
// tensor cores work on this one. Rows are padded by 16 bytes, which keeps
// the fragment reads free of bank conflicts. TMA, wgmma and a deeper
// pipeline are later work.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int WARPS_N = 4, WTM = 64, WTN = 32;  // 2 x 4 warps
constexpr int MT = WTM / 16, NT = WTN / 8;
constexpr int LD = BK + 16;                 // bytes per shared row
constexpr int XCH = BM * BK / 16 / THREADS;  // 16-byte x chunks per thread
constexpr int WCH = (BK / 4) * (BN / 4) / THREADS;  // 4 x 4 w blocks
static_assert(XCH * 16 * THREADS == BM * BK, "x chunks");
static_assert(WCH * 16 * THREADS == BK * BN, "w blocks");

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4],
                                             const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
i8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
             int32_t* __restrict__ o, int M, int N, int K) {
  __shared__ __align__(16) uint8_t sx[BM * LD];  // [m][k]
  __shared__ __align__(16) uint8_t sw[BN * LD];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WTM, wn0 = (warp % WARPS_N) * WTN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  uint4 xr[XCH];
  uint32_t wr[WCH][4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 16),
                k = (c % (BK / 16)) * 16;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + k < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K +
                                                k0 + k);
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * THREADS, kb = c / (BN / 4), nb = c % (BN / 4);
      const int k = k0 + 4 * kb, n = n0 + 4 * nb;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wr[i][j] = (k < K && n < N)
                       ? *reinterpret_cast<const uint32_t*>(
                             w + (size_t)(k + j) * N + n)
                       : 0u;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 16),
                k = (c % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(sx + r * LD + k) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * THREADS, kb = c / (BN / 4), nb = c % (BN / 4);
      // rows k .. k+3 (4 columns each) -> columns n .. n+3 (4 k each)
      const uint32_t t0 = __byte_perm(wr[i][0], wr[i][1], 0x5140);
      const uint32_t t1 = __byte_perm(wr[i][0], wr[i][1], 0x7362);
      const uint32_t u0 = __byte_perm(wr[i][2], wr[i][3], 0x5140);
      const uint32_t u1 = __byte_perm(wr[i][2], wr[i][3], 0x7362);
      const uint32_t cols[4] = {__byte_perm(t0, u0, 0x5410),
                                __byte_perm(t0, u0, 0x7632),
                                __byte_perm(t1, u1, 0x5410),
                                __byte_perm(t1, u1, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sw + (4 * nb + j) * LD + 4 * kb) =
            cols[j];
    }
  };

  int acc[MT][NT][4] = {};
  const int nk = (K + BK - 1) / BK;
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK);  // in flight during the mma
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint8_t* p = sx + (wm0 + mt * 16 + g) * LD + ks * 32 + 4 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* p = sw + (wn0 + nt * 8 + g) * LD + ks * 32 + 4 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt]);
    }
    __syncthreads();  // sx and sw are rewritten by the next step
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        if (col < N)  // N % 16 == 0: col + 1 < N too
          *reinterpret_cast<int2*>(o + (size_t)row * N + col) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). Needs M > 0,
// K and N positive multiples of 16 (16-byte rows), and 16-byte aligned
// operands. Launches on ``stream``; does not synchronise and allocates
// nothing.
extern "C" int lc_i8_matmul(const void* x, const void* w, void* o, int M,
                            int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  i8_mm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(o), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
