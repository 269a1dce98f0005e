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
// later work here (the resident chain, matmul_resident.cu, has them, on
// hopper.cuh).
#include "mm_tile.cuh"

namespace {

using namespace lc;

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

// -------------------------------------------------------------- tensor cores

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
  static unsigned long long attr_devices = 0;  // per instantiation
  const cudaError_t e =
      lc::smem_limit_per_device(kern, T::SMEM_BYTES, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
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
