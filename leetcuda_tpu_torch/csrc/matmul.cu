// Dense matmul for Hopper: out (M, N) = x (M, K) @ y, NN (y is (K, N)) or TN
// (y is (N, K), contracted on its last dim), summed in f32 and rounded once
// to the output dtype (f32, f16 or bf16).
//
// Replaces: leetcuda_tpu/gemm/matmul.py make_matmul (_mm_kernel, and the
// grouped tile walk _swizzled_ij). As there, any M, N and K, and no value
// past M, N or K reaches a sum (padding may hold NaN, and 0 * NaN = NaN;
// the Pallas kernel masks both operands' K tails for that reason).
//
// Bound on an H100 SXM: operations for every shape the library is driven at
// (8192^3 bf16: 1.1 TFLOP, 1.11 ms at 989 TFLOP/s; f32 on the CUDA cores at
// 67 TFLOP/s). Two datapaths:
// - f16 / bf16 on the tensor cores: the persistent, warp-specialised TMA +
//   wgmma kernel of gemm_sm90.cuh (a producer thread and a ring of
//   mbarrier-guarded stages, one or two consumer warpgroups, CTA pairs
//   multicasting the B panel, a storer's TMA-store epilogue, one CTA or
//   pair an SM walking the tiles). NN reads y MN-major (the transpose bit),
//   TN K-major. TMA reads zeros past M, N and K, so only 16-byte row
//   strides are asked of the operands: the wrapper pads K and N with zeros
//   where they are not multiples of 8 (exact) and slices the result. Three
//   tiles (Config below; gemm/matmul.py BLOCKS keeps the old keys for them).
// - f32 (and the naive / sliced-k f16 rungs) on the CUDA cores with f32 FMA,
//   no TF32: one thread per output (naive), or shared-memory tiles with each
//   thread holding a TM x TN register block (sliced-k, 8x8), optionally
//   double-buffered; every load guarded.
// The tile walk is the Pallas grid's: row-major over (M / BM, N / BN), or
// with ``group`` > 0 grouped ``group`` tile-columns at a time, the last group
// narrower (the _swizzled_ij semantics, tile_ij in gemm_sm90.cuh); on Hopper
// its point is L2 reuse of the B panels. The tensor-core kernel walks the
// same order over its units (pairs of row blocks when CTAs pair up).
#include "gemm_sm90.cuh"
#include "mm_tile.cuh"

#ifndef LC_MM_STAGES128
#define LC_MM_STAGES128 6  // stages of the 128 x 128 tile
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

// ---------------------------------------------------------------- CUDA cores

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

// ---------------------------------------------------------------- launches

// The instantiations ``config`` selects (gemm/matmul.py BLOCKS names them).
enum Config {
  kNaive = 0,     // (16, 16, 1): one thread per output
  kSliced = 1,    // (32, 32, 32): 2 x 2 per thread
  kT8x8 = 2,      // (128, 128, 8): 8 x 8 per thread
  kT8x8Dbuf = 3,  // (128, 128, 16): 8 x 8 per thread, double-buffered
  kTc64 = 4,      // wgmma 64 x 64 tiles: one consumer warpgroup, 3 CTAs an SM
  kTc128 = 5,     // wgmma 128 x 128: two consumer warpgroups, CTA pairs
  kTc256 = 6,     // wgmma 128 x 256: two consumer warpgroups, CTA pairs
};

// (BM, BN, stages, cluster, CTAs an SM), per layout
template <int kB>
using Tc64 = GemmPlan<64, 64, 4, 1, 3, kB>;
template <int kB>
using Tc128 = GemmPlan<128, 128, LC_MM_STAGES128, 2, 1, kB>;
template <int kB>
using Tc256 = GemmPlan<128, 256, 3, 2, 1, kB>;

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

template <bool kHalf, bool kTN>
int launch_tc(int config, const void* x, const void* y, void* o, int M, int N,
              int K, int odt, int group, int grid, cudaStream_t st) {
  constexpr int kB = kTN ? kBnk : kBkn;
  switch (config) {
    case kTc64:
      return gemm_sm90_launch<Tc64<kB>, kHalf, false>(x, y, nullptr, o, M, N,
                                                      K, odt, group, grid, st);
    case kTc128:
      return gemm_sm90_launch<Tc128<kB>, kHalf, false>(
          x, y, nullptr, o, M, N, K, odt, group, grid, st);
    case kTc256:
      return gemm_sm90_launch<Tc256<kB>, kHalf, false>(
          x, y, nullptr, o, M, N, K, odt, group, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kTN>
int dispatch(int config, int dtype, const void* x, const void* y, void* o,
             int M, int N, int K, int odt, int group, int grid,
             cudaStream_t st) {
  if (config >= kTc64) {
    if (K % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF16)
      return launch_tc<true, kTN>(config, x, y, o, M, N, K, odt, group, grid,
                                  st);
    if (dtype == kBF16)
      return launch_tc<false, kTN>(config, x, y, o, M, N, K, odt, group,
                                   grid, st);
    return static_cast<int>(cudaErrorInvalidValue);  // f32: CUDA cores only
  }
  if (dtype == kF32)
    return launch_simt<float, kTN>(config, x, y, o, M, N, K, odt, group, st);
  if (dtype == kF16)
    return launch_simt<__half, kTN>(config, x, y, o, M, N, K, odt, group, st);
  return launch_simt<__nv_bfloat16, kTN>(config, x, y, o, M, N, K, odt, group,
                                         st);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). ``dtype`` is
// x's and y's (0 f32, 1 f16, 2 bf16), ``odt`` the output's; ``tn`` selects
// y (N, K); ``config`` the instantiation (Config above; 4-6 take f16 / bf16
// only, K and N multiples of 8, and ``grid`` CTAs: a multiple of the
// cluster, at most the co-resident count, lc_matmul_info); ``group`` > 0
// the grouped tile walk. Needs M, N, K > 0, contiguous 16-byte aligned
// operands and fewer than 2^31 output tiles. Launches on ``stream``; does
// not synchronise and allocates nothing.
extern "C" int lc_matmul(const void* x, const void* y, void* o, int M, int N,
                         int K, int dtype, int odt, int tn, int config,
                         int group, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || dtype < 0 || dtype > 2 || odt < 0 ||
      odt > 2 || config < 0 || config > kTc256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tn ? dispatch<true>(config, dtype, x, y, o, M, N, K, odt, group,
                             grid, st)
            : dispatch<false>(config, dtype, x, y, o, M, N, K, odt, group,
                              grid, st);
}

// What tensor-core ``config`` (4-6) launches on the current device: info =
// {BM, BN, BK, stages, cluster, co-resident CTAs} (the bf16 NN build; the
// other types and layouts share the tile and the shared memory). Returns a
// CUDA error code.
extern "C" int lc_matmul_info(int config, int* info) {
  switch (config) {
    case kTc64:
      return gemm_sm90_info<Tc64<kBkn>, false, false>(info);
    case kTc128:
      return gemm_sm90_info<Tc128<kBkn>, false, false>(info);
    case kTc256:
      return gemm_sm90_info<Tc256<kBkn>, false, false>(info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
