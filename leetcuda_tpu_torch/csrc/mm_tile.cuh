// The matmul tiles the dense matmul (matmul.cu) and the grouped matmul
// (gmm.cu) share: a CTA computes a BM x BN output tile at (m0, n0) of
// x (M, K) @ y, NN (y (K, N)) or TN (y (N, K)), summed in f32 and rounded
// once to the output dtype (f32, f16 or bf16). Every load is guarded, so
// that no value past M, N or K reaches a sum.
// - simt_tile: f32 FMA on the CUDA cores (no TF32), shared-memory tiles,
//   a TM x TN register block a thread.
// - tc_tile: f16 / bf16 on the tensor cores, mma.sync m16n8k16 with an f32
//   accumulator, cp.async stages in a ring, ldmatrix fragments.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"
#include "dtype.cuh"

namespace lc {

__device__ __forceinline__ void store_out(void* o, size_t i, float v,
                                          int odt) {
  if (odt == kF32)
    static_cast<float*>(o)[i] = v;
  else if (odt == kF16)
    static_cast<__half*>(o)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(v);
}

template <class T, bool kTN>
__device__ __forceinline__ float load_y(const T* y, int k, int n, int N,
                                        int K) {
  return to_f32(kTN ? y[(size_t)n * K + k] : y[(size_t)k * N + n]);
}


// Shared-memory tiles (BM x BK of x, BK x BN of y, both as f32, k-major),
// each thread a TM x TN register block; kDbuf: two tile buffers, the next
// one loaded while this one is multiplied, one barrier a k step.
// The CTA's output tile at (m0, n0). x and y are not __restrict__ here: the
// resident chain reads rows that the same kernel wrote.
template <class T, int BM, int BN, int BK, int TM, int TN, bool kDbuf,
          bool kTN>
__device__ __forceinline__ void simt_tile(const T* x, const T* y, void* o,
                                          int M, int N, int K, int odt,
                                          int m0, int n0) {
  constexpr int kThreads = (BM / TM) * (BN / TN), kS = kDbuf ? 2 : 1;
  __shared__ __align__(16) float sa[kS][BK][BM + 4];
  __shared__ __align__(16) float sb[kS][BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % (BN / TN), ty = tid / (BN / TN);

  auto load = [&](int s, int k0) {
    for (int c = tid; c < BM * BK; c += kThreads) {
      const int m = c / BK, k = c % BK, gm = m0 + m, gk = k0 + k;
      sa[s][k][m] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
    }
    for (int c = tid; c < BK * BN; c += kThreads) {
      const int k = kTN ? c % BK : c / BN, n = kTN ? c / BK : c % BN;
      const int gk = k0 + k, gn = n0 + n;
      sb[s][k][n] = (gk < K && gn < N) ? load_y<T, kTN>(y, gk, gn, N, K) : 0.f;
    }
  };

  float acc[TM][TN] = {};
  auto compute = [&](int s) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = sa[s][k][ty * TM + r];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = sb[s][k][tx * TN + c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  };

  const int nk = (K + BK - 1) / BK;
  if constexpr (kDbuf) {
    load(0, 0);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * BK);
      compute(kt & 1);
      __syncthreads();
    }
  } else {
    for (int kt = 0; kt < nk; ++kt) {
      load(0, kt * BK);
      __syncthreads();
      compute(0);
      __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int row = m0 + ty * TM + r;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = n0 + tx * TN + c;
      if (col < N) store_out(o, (size_t)row * N + col, acc[r][c], odt);
    }
  }
}

// -------------------------------------------------------------- tensor cores

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// D (16 x 8, f32) += A (16 x 16) * B (16 x 8), f16 or bf16 operands; the
// fragments as in common.cuh mma_bf16_16816.
template <bool kF16In>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  if constexpr (kF16In) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    lc::mma_bf16_16816(c, a, b);
  }
}

// A CTA of WARPS_M x WARPS_N warps computes a BM x BN tile, 32-deep k steps,
// in a ring of STAGES shared-memory stages. Per stage: sa[BM][BK + 8] (row
// m, column k) and sb, NN: [BK][BN + 8] (row k, column n), TN: [BN][BK + 8]
// (row n, column k); 16-bit elements.
template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_>
struct Tc {
  static constexpr int BM = BM_, BN = BN_, BK = 32, WARPS_M = WARPS_M_,
                       WARPS_N = WARPS_N_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int LDA = BK + 8, A_ELEMS = BM * LDA;
  static constexpr int B_ELEMS = BK * (BN + 8) > BN * (BK + 8)
                                     ? BK * (BN + 8)
                                     : BN * (BK + 8);
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * 2;
  static_assert(WTM % 16 == 0 && WTN % 16 == 0, "warp tile");
  static_assert((BM * BK / 8) % THREADS == 0 && (BK * BN / 8) % THREADS == 0,
                "16-byte chunks per thread");
};

// Chunk (row, col .. col + 7) of a row-major 16-bit matrix (rows x cols,
// row stride ld) into shared memory at ``dst``; zeros past rows or cols.
__device__ __forceinline__ void load_chunk(uint16_t* dst,
                                           const uint16_t* src,
                                           int row, int col, int rows,
                                           int cols, int ld, bool vec) {
  if (vec) {  // cols and ld are multiples of 8: the chunk is all in or out
    const bool in = row < rows && col < cols;
    cp_async16(dst, in ? src + (size_t)row * ld + col : src, in ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[e] = (row < rows && col + e < cols) ? src[(size_t)row * ld + col + e]
                                              : uint16_t(0);
  }
}

// The CTA's output tile at (m0, n0), staged through ``smem`` (T::STAGES
// stages). x and y are not __restrict__ here (see simt_tile).
template <class T, bool kF16In, bool kTN>
__device__ __forceinline__ void tc_tile(const uint16_t* x, const uint16_t* y,
                                        void* o, int M, int N, int K, int odt,
                                        int m0, int n0, int vec,
                                        uint16_t* smem) {
  constexpr int LDB = kTN ? T::BK + 8 : T::BN + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / T::WARPS_N) * T::WTM;
  const int wn0 = (warp % T::WARPS_N) * T::WTN;

  auto load_stage = [&](int s, int k0) {
    uint16_t* sa = smem + s * T::STAGE_ELEMS;
    uint16_t* sb = sa + T::A_ELEMS;
#pragma unroll
    for (int c = tid; c < T::BM * T::BK / 8; c += T::THREADS) {
      const int r = c / (T::BK / 8), k = (c % (T::BK / 8)) * 8;
      load_chunk(sa + r * T::LDA + k, x, m0 + r, k0 + k, M, K, K, vec);
    }
#pragma unroll
    for (int c = tid; c < T::BK * T::BN / 8; c += T::THREADS) {
      if constexpr (kTN) {  // y (N, K): row n, 8 columns of k
        const int r = c / (T::BK / 8), k = (c % (T::BK / 8)) * 8;
        load_chunk(sb + r * LDB + k, y, n0 + r, k0 + k, N, K, K, vec);
      } else {  // y (K, N): row k, 8 columns of n
        const int r = c / (T::BN / 8), n = (c % (T::BN / 8)) * 8;
        load_chunk(sb + r * LDB + n, y, k0 + r, n0 + n, K, N, N, vec);
      }
    }
  };

  float acc[T::MT][T::NT][4] = {};
  auto compute = [&](int s) {
    const uint16_t* sa = smem + s * T::STAGE_ELEMS;
    const uint16_t* sb = sa + T::A_ELEMS;
#pragma unroll
    for (int ks = 0; ks < T::BK / 16; ++ks) {
      uint32_t a[T::MT][4], b[T::NT][2];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldsm_x4(a[mt], sa + (wm0 + mt * 16 + (lane & 15)) * T::LDA + ks * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < T::NT / 2; ++np) {
        uint32_t r[4];
        if constexpr (kTN)
          ldsm_x4(r, sb + (wn0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDB +
                         ks * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_trans(r, sb + (ks * 16 + (lane & 15)) * LDB + wn0 +
                               np * 16 + (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
          mma16816<kF16In>(acc[mt][nt], a[mt], b[nt]);
    }
  };

  const int nk = (K + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s * T::BK);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<T::STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();           // ... everyone's; stage (kt - 1) is free
    const int pf = kt + T::STAGES - 1;
    if (pf < nk) load_stage(pf % T::STAGES, pf * T::BK);
    cp_commit();
    compute(kt % T::STAGES);
  }
  cp_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int col = n0 + wn0 + nt * 8 + 2 * t;
        if (col < N)
          store_out(o, (size_t)row * N + col, acc[mt][nt][2 * h], odt);
        if (col + 1 < N)
          store_out(o, (size_t)row * N + col + 1, acc[mt][nt][2 * h + 1], odt);
      }
    }
}

}  // namespace lc
