// Dense matmul for Hopper: out (M, N) = x (M, K) @ y, NN (y is (K, N)) or TN
// (y is (N, K), contracted on its last dim), summed in f32 and rounded once
// to the output dtype (f32, f16 or bf16).
//
// Replaces: leetcuda_tpu/gemm/matmul.py make_matmul (_mm_kernel, and the
// grouped tile walk _swizzled_ij). As there, any M, N and K: every load is
// guarded, so that no value past M, N or K reaches a sum (padding may hold
// NaN, and 0 * NaN = NaN; the Pallas kernel masks both operands' K tails for
// that reason).
//
// Bound on an H100 SXM: operations for every shape the library is driven at
// (8192^3 bf16: 1.1 TFLOP, 1.11 ms at 989 TFLOP/s; f32 on the CUDA cores at
// 67 TFLOP/s). Design, simple first, two datapaths:
// - f16 / bf16 on the tensor cores: mma.sync m16n8k16 with an f32
//   accumulator; x and y tiles go device memory -> shared memory by
//   cp.async, 16 bytes a thread, in a ring of 2 or 3 stages, so the next
//   tiles load while the tensor cores work; fragments come out of shared
//   memory by ldmatrix (.trans for NN's (K, N) B, which mma wants k-major).
//   Rows are padded by 16 bytes, which makes the ldmatrix reads free of
//   bank conflicts. Where K (or N for NN) is not a multiple of 8 the tiles
//   load element by element instead (16-byte chunks would straddle rows).
// - f32 (and the naive / sliced-k f16 rungs) on the CUDA cores with f32 FMA,
//   no TF32: one thread per output (naive), or shared-memory tiles with each
//   thread holding a TM x TN register block (sliced-k, 8x8), optionally
//   double-buffered.
// The tile walk is the Pallas grid's: row-major over (M / BM, N / BN), or
// with ``group`` > 0 grouped ``group`` tile-columns at a time, the last group
// narrower (the _swizzled_ij semantics); on Hopper its point is L2 reuse of
// the B panels. wgmma, TMA, warp specialisation and a persistent walk are
// later work.
//
// Also replaces make_matmul_resident (gemm/matmul.py, the VMEM-resident
// chain A <- cast(A @ B), ``reps`` times in one call): the same tiles, a CTA
// owning a block of rows for every rep (mm_resident below). Bound:
// operations (4096^3 bf16, reps 5: 687 GFLOP, 0.695 ms at 989 TFLOP/s).
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

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

__device__ __forceinline__ void store_out(void* o, size_t i, float v,
                                          int odt) {
  if (odt == kF32)
    static_cast<float*>(o)[i] = v;
  else if (odt == kF16)
    static_cast<__half*>(o)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(v);
}

// Linear tile counter t -> output tile (i, j): row-major over an ni x nj
// grid, or, for group > 0, every i of ``group`` columns before the next
// group, the last group narrower when group does not divide nj.
__device__ __forceinline__ void tile_ij(int t, int ni, int nj, int group,
                                        int& i, int& j) {
  if (group <= 0) {
    i = t / nj;
    j = t % nj;
    return;
  }
  const int per = ni * group, g = t / per, r = t % per;
  const int cur = min(group, nj - g * group);
  i = r / cur;
  j = g * group + r % cur;
}

// ---------------------------------------------------------------- CUDA cores

template <class T, bool kTN>
__device__ __forceinline__ float load_y(const T* y, int k, int n, int N,
                                        int K) {
  return to_f32(kTN ? y[(size_t)n * K + k] : y[(size_t)k * N + n]);
}

// One thread per output, k straight from device memory.
template <class T, bool kTN>
__global__ void __launch_bounds__(256)
mm_naive(const T* __restrict__ x, const T* __restrict__ y, void* o, int M,
         int N, int K, int odt, int group) {
  int i, j;
  tile_ij(blockIdx.x, (M + 15) / 16, (N + 15) / 16, group, i, j);
  const int row = i * 16 + threadIdx.y, col = j * 16 + threadIdx.x;
  if (row >= M || col >= N) return;
  float acc = 0.f;
  for (int k = 0; k < K; ++k)
    acc = fmaf(to_f32(x[(size_t)row * K + k]), load_y<T, kTN>(y, k, col, N, K),
               acc);
  store_out(o, (size_t)row * N + col, acc, odt);
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

template <class T, int BM, int BN, int BK, int TM, int TN, bool kDbuf,
          bool kTN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
mm_simt(const T* __restrict__ x, const T* __restrict__ y, void* o, int M,
        int N, int K, int odt, int group) {
  int ti, tj;
  tile_ij(blockIdx.x, (M + BM - 1) / BM, (N + BN - 1) / BN, group, ti, tj);
  simt_tile<T, BM, BN, BK, TM, TN, kDbuf, kTN>(x, y, o, M, N, K, odt,
                                               ti * BM, tj * BN);
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

template <class T, bool kF16In, bool kTN>
__global__ void __launch_bounds__(T::THREADS)
mm_tc(const uint16_t* __restrict__ x, const uint16_t* __restrict__ y,
      void* o, int M, int N, int K, int odt, int group, int vec) {
  extern __shared__ __align__(16) uint16_t smem[];
  int ti, tj;
  tile_ij(blockIdx.x, (M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN, group,
          ti, tj);
  tc_tile<T, kF16In, kTN>(x, y, o, M, N, K, odt, ti * T::BM, tj * T::BN, vec,
                          smem);
}

// ------------------------------------------------------ the resident chain

// A <- cast(A @ B), ``reps`` times in one launch, B (N, N). B is constant,
// so row block i evolves on its own (C[i] = A[i] B^reps, rounded each rep):
// a CTA owns Step::BM rows for every rep, with no grid-wide barrier. Rep r
// reads its rows from ``a`` (r = 0) or the previous rep's buffer and writes
// them, tile by tile across N, to ``out`` or ``scratch``, the parity chosen
// so that the last rep writes ``out``; a fence and a barrier between reps
// make the rows visible to the whole CTA. B is re-read from L2 every rep
// (32 MB at 4096^2 bf16 fits the H100's 50 MB), and A and the result cross
// HBM once. ``Step`` is the tile: TcStep (tensor cores) or SimtStep (f32).
template <class Step>
__global__ void __launch_bounds__(Step::THREADS)
mm_resident(const typename Step::E* a, const typename Step::E* b,
            typename Step::E* out, typename Step::E* scratch, int M, int N,
            int reps, int odt, int vec) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int m0 = blockIdx.x * Step::BM;
  const typename Step::E* src = a;
  for (int r = 0; r < reps; ++r) {
    typename Step::E* dst = ((reps - 1 - r) & 1) ? scratch : out;
    for (int n0 = 0; n0 < N; n0 += Step::BN) {
      __syncthreads();  // the previous tile's reads of smem are done
      Step::tile(src, b, dst, M, N, odt, m0, n0, vec, smem);
    }
    // this rep's rows, written by all, reach L2 (where cp.async.cg reads)
    // before any thread reads them
    __threadfence();
    __syncthreads();
    src = dst;
  }
}

// The chain's tiles: (M, N) @ (N, N), NN.
template <class T, bool kF16In>
struct TcStep {
  using E = uint16_t;
  static constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS,
                       SMEM_BYTES = T::SMEM_BYTES;
  __device__ static void tile(const E* x, const E* y, void* o, int M, int N,
                              int odt, int m0, int n0, int vec,
                              uint16_t* smem) {
    tc_tile<T, kF16In, false>(x, y, o, M, N, N, odt, m0, n0, vec, smem);
  }
};

template <int BM_, int BN_, int BK, int TM, int TN>
struct SimtStep {  // f32 on the CUDA cores (no TF32); static shared memory
  using E = float;
  static constexpr int BM = BM_, BN = BN_, THREADS = (BM / TM) * (BN / TN),
                       SMEM_BYTES = 0;
  __device__ static void tile(const E* x, const E* y, void* o, int M, int N,
                              int odt, int m0, int n0, int, uint16_t*) {
    simt_tile<float, BM, BN, BK, TM, TN, true, false>(x, y, o, M, N, N, odt,
                                                       m0, n0);
  }
};

// ---------------------------------------------------------------- launches

// The instantiations ``config`` selects (gemm/matmul.py BLOCKS names them).
enum Config {
  kNaive = 0,     // (16, 16, 1): one thread per output
  kSliced = 1,    // (32, 32, 32): 2 x 2 per thread
  kT8x8 = 2,      // (128, 128, 8): 8 x 8 per thread
  kT8x8Dbuf = 3,  // (128, 128, 16): 8 x 8 per thread, double-buffered
  kTc64 = 4,      // (64, 64, 32): 4 warps 2 x 2, 2 stages
  kTc128 = 5,     // (128, 128, 32): 8 warps 2 x 4, 3 stages
  kTc256 = 6,     // (128, 256, 32): 8 warps 2 x 4, 3 stages
};

using Tc64 = Tc<64, 64, 2, 2, 2>;
using Tc128 = Tc<128, 128, 2, 4, 3>;
using Tc256 = Tc<128, 256, 2, 4, 3>;
// The resident chain's tile: 64 rows (a CTA's rows for every rep; 64 CTAs
// at 4096 rows on the 132 SMs) by 256 columns, 8 warps 2 x 4, 3 stages.
using TcRes = Tc<64, 256, 2, 4, 3>;
constexpr int kResRows = 64;  // rows of a CTA of the f32 chain too

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <class T, bool kTN>
int launch_simt(int config, const void* x, const void* y, void* o, int M,
                int N, int K, int odt, int group, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  switch (config) {
    case kNaive:
      mm_naive<T, kTN><<<cdiv(M, 16) * cdiv(N, 16), dim3(16, 16), 0, st>>>(
          xt, yt, o, M, N, K, odt, group);
      break;
    case kSliced:
      mm_simt<T, 32, 32, 32, 2, 2, false, kTN>
          <<<cdiv(M, 32) * cdiv(N, 32), 256, 0, st>>>(xt, yt, o, M, N, K, odt,
                                                       group);
      break;
    case kT8x8:
      mm_simt<T, 128, 128, 8, 8, 8, false, kTN>
          <<<cdiv(M, 128) * cdiv(N, 128), 256, 0, st>>>(xt, yt, o, M, N, K,
                                                         odt, group);
      break;
    case kT8x8Dbuf:
      mm_simt<T, 128, 128, 16, 8, 8, true, kTN>
          <<<cdiv(M, 128) * cdiv(N, 128), 256, 0, st>>>(xt, yt, o, M, N, K,
                                                         odt, group);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool kF16In, bool kTN>
int launch_tc_one(const void* x, const void* y, void* o, int M, int N, int K,
                  int odt, int group, int vec, cudaStream_t st) {
  auto kern = mm_tc<T, kF16In, kTN>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<cdiv(M, T::BM) * cdiv(N, T::BN), T::THREADS, T::SMEM_BYTES, st>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(y), o, M,
      N, K, odt, group, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kF16In, bool kTN>
int launch_tc(int config, const void* x, const void* y, void* o, int M, int N,
              int K, int odt, int group, cudaStream_t st) {
  const int vec = (K % 8 == 0) && (kTN || N % 8 == 0);
  switch (config) {
    case kTc64:
      return launch_tc_one<Tc64, kF16In, kTN>(x, y, o, M, N, K, odt, group,
                                              vec, st);
    case kTc128:
      return launch_tc_one<Tc128, kF16In, kTN>(x, y, o, M, N, K, odt, group,
                                               vec, st);
    case kTc256:
      return launch_tc_one<Tc256, kF16In, kTN>(x, y, o, M, N, K, odt, group,
                                               vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kTN>
int dispatch(int config, int dtype, const void* x, const void* y, void* o,
             int M, int N, int K, int odt, int group, cudaStream_t st) {
  if (config >= kTc64) {
    if (dtype == kF16)
      return launch_tc<true, kTN>(config, x, y, o, M, N, K, odt, group, st);
    if (dtype == kBF16)
      return launch_tc<false, kTN>(config, x, y, o, M, N, K, odt, group, st);
    return static_cast<int>(cudaErrorInvalidValue);  // f32: CUDA cores only
  }
  if (dtype == kF32)
    return launch_simt<float, kTN>(config, x, y, o, M, N, K, odt, group, st);
  if (dtype == kF16)
    return launch_simt<__half, kTN>(config, x, y, o, M, N, K, odt, group, st);
  return launch_simt<__nv_bfloat16, kTN>(config, x, y, o, M, N, K, odt, group,
                                         st);
}

template <class Step>
int launch_resident(const void* a, const void* b, void* o, void* scratch,
                    int M, int N, int reps, int odt, cudaStream_t st) {
  using E = typename Step::E;
  auto kern = mm_resident<Step>;
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Step::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  kern<<<cdiv(M, Step::BM), Step::THREADS, Step::SMEM_BYTES, st>>>(
      static_cast<const E*>(a), static_cast<const E*>(b), static_cast<E*>(o),
      static_cast<E*>(scratch), M, N, reps, odt, N % 8 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). ``dtype`` is
// x's and y's (0 f32, 1 f16, 2 bf16), ``odt`` the output's; ``tn`` selects
// y (N, K); ``config`` the instantiation (Config above; 4-6 take f16 / bf16
// only); ``group`` > 0 the grouped tile walk. Needs M, N, K > 0, contiguous
// 16-byte aligned operands and fewer than 2^31 output tiles. Launches on
// ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_matmul(const void* x, const void* y, void* o, int M, int N,
                         int K, int dtype, int odt, int tn, int config,
                         int group, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || dtype < 0 || dtype > 2 || odt < 0 ||
      odt > 2 || config < 0 || config > kTc256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tn ? dispatch<true>(config, dtype, x, y, o, M, N, K, odt, group, st)
            : dispatch<false>(config, dtype, x, y, o, M, N, K, odt, group, st);
}

// The resident chain: o (M, N) = a (M, N) @ b^reps, b (N, N), rounded to
// ``dtype`` (0 f32, 1 f16, 2 bf16) after every rep, in one launch of
// cdiv(M, 64) CTAs. ``scratch`` (M, N, of the same dtype) holds every other
// rep's rows (unused when reps == 1); a and b are never written. Needs
// M, N > 0, reps >= 1, contiguous 16-byte aligned operands. Returns
// cudaGetLastError() after the launch (0 = launched) on ``stream``; does
// not synchronise and allocates nothing.
extern "C" int lc_matmul_resident(const void* a, const void* b, void* o,
                                  void* scratch, int M, int N, int reps,
                                  int dtype, void* stream) {
  if (M <= 0 || N <= 0 || reps < 1 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return launch_resident<TcStep<TcRes, true>>(a, b, o, scratch, M, N, reps,
                                                dtype, st);
  if (dtype == kBF16)
    return launch_resident<TcStep<TcRes, false>>(a, b, o, scratch, M, N, reps,
                                                 dtype, st);
  return launch_resident<SimtStep<kResRows, 128, 16, 4, 8>>(
      a, b, o, scratch, M, N, reps, dtype, st);
}
