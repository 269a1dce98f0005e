// Grouped matmul for Hopper: out (T, N) = lhs (T, K) @ rhs[g] (K, N), where
// row tile i (rows [i bm, (i + 1) bm)) takes the expert panel
// g = tile_group[i]; summed in f32 and rounded once to lhs's dtype (f32,
// f16 or bf16).
//
// Replaces: leetcuda_tpu/gemm/grouped.py make_gmm (_gmm_kernel, whose
// scalar-prefetched tile_group steers each row tile's rhs BlockSpec). Here a
// CTA reads its own tile's expert id from device memory; nothing goes
// through the host, so the caller's routing stays on the device.
//
// Bound on an H100 SXM, at Qwen3-30B-A3B's shapes (K / N 2048 / 768):
// bytes at decode (a B=8 step's 16512-row buffer and the ~54 expert panels
// of 3 MB it touches: 0.078 ms at 3.35 TB/s, while all its rows' 52 GFLOP
// take 0.053 ms at 989 TFLOP/s); bytes and operations alike at an 8 x 1024
// prefill (81920 rows: 0.26 ms). Design, simple first: the dense
// matmul's tiles (mm_tile.cuh), one CTA a 128 x 128 output tile. Each CTA
// owns rows of one row tile only (a row tile of bm rows is cut into
// ceil(bm / 128) CTA row blocks, the last one shorter), so a CTA never
// straddles two experts; it then walks K over its expert's (K, N) panel:
// - f16 / bf16 on the tensor cores (mma.sync m16n8k16, cp.async stages);
// - f32 on the CUDA cores (8 x 8 register blocks, double-buffered), no TF32.
// CTAs walk N fastest, so the CTAs of a row tile, and the row tiles of an
// expert after them, read one panel while it is in L2. Every tile is
// computed, the MoE buffer's zero padding rows and dead tiles too (that is
// the function the TPU kernel computes); skipping them, wgmma and TMA are
// later work. An expert id outside [0, G) writes NaN over its tile rather
// than read past rhs.
#include "mm_tile.cuh"

namespace {

using namespace lc;

// The tensor-core tile: 128 x 128, 8 warps 2 x 4, 3 stages (matmul.cu's
// Tc128).
template <bool kF16In>
struct TcGmm {
  using E = uint16_t;
  using T = Tc<128, 128, 2, 4, 3>;
  static constexpr int BM = T::BM, BN = T::BN, THREADS = T::THREADS,
                       SMEM_BYTES = T::SMEM_BYTES;
  __device__ static void tile(const E* x, const E* y, void* o, int M, int N,
                              int K, int odt, int n0, int vec,
                              uint16_t* smem) {
    tc_tile<T, kF16In, false>(x, y, o, M, N, K, odt, 0, n0, vec, smem);
  }
};

// The f32 tile: 128 x 128, 16-deep k steps, 8 x 8 a thread, double-buffered
// (matmul.cu's F32_DEFAULT); static shared memory.
struct SimtGmm {
  using E = float;
  static constexpr int BM = 128, BN = 128, THREADS = 256, SMEM_BYTES = 0;
  __device__ static void tile(const E* x, const E* y, void* o, int M, int N,
                              int K, int odt, int n0, int, uint16_t*) {
    simt_tile<float, 128, 128, 16, 8, 8, true, false>(x, y, o, M, N, K, odt,
                                                       0, n0);
  }
};

// CTA t: column tile j = t % nj, then CTA row block s of row tile i. Its
// rows start at r0 = i bm + s BM; ``lhs`` and ``out`` are offset there, so
// the tile's row count bounds the rows it reads and writes.
template <class Step>
__global__ void __launch_bounds__(Step::THREADS)
gmm_kernel(const typename Step::E* __restrict__ lhs,
           const typename Step::E* __restrict__ rhs,
           const int* __restrict__ tile_group, void* out, int K, int N,
           int G, int bm, int odt, int vec) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int nj = (N + Step::BN - 1) / Step::BN;
  const int nsub = (bm + Step::BM - 1) / Step::BM;
  const int j = blockIdx.x % nj, s = (blockIdx.x / nj) % nsub,
            i = blockIdx.x / (nj * nsub);
  const size_t r0 = (size_t)i * bm + (size_t)s * Step::BM;
  const int rows = min(Step::BM, bm - s * Step::BM);
  void* o = static_cast<char*>(out) + r0 * N * (odt == kF32 ? 4 : 2);
  const int g = tile_group[i];
  if (g < 0 || g >= G) {
    const float nan = __int_as_float(0x7fc00000);
    for (int c = threadIdx.x; c < rows * Step::BN; c += Step::THREADS) {
      const int col = j * Step::BN + c % Step::BN;
      if (col < N) store_out(o, (size_t)(c / Step::BN) * N + col, nan, odt);
    }
    return;
  }
  Step::tile(lhs + r0 * K, rhs + (size_t)g * K * N, o, rows, N, K, odt,
             j * Step::BN, vec, smem);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

template <class Step>
int launch(const void* lhs, const void* rhs, const int* tile_group, void* out,
           int T, int K, int N, int G, int bm, int odt, cudaStream_t st) {
  using E = typename Step::E;
  auto kern = gmm_kernel<Step>;
  static unsigned long long attr_devices = 0;  // per instantiation
  if (Step::SMEM_BYTES > 0) {
    const cudaError_t e =
        lc::smem_limit_per_device(kern, Step::SMEM_BYTES, attr_devices);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid =
      (long long)(T / bm) * cdiv(bm, Step::BM) * cdiv(N, Step::BN);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (K % 8 == 0) && (N % 8 == 0);
  kern<<<static_cast<unsigned>(grid), Step::THREADS, Step::SMEM_BYTES, st>>>(
      static_cast<const E*>(lhs), static_cast<const E*>(rhs), tile_group, out,
      K, N, G, bm, odt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (T, N) = row tile i of lhs (T, K) @ rhs[tile_group[i]] (K, N), for
// the T / bm row tiles. ``dtype`` is lhs's, rhs's and out's (0 f32, 1 f16,
// 2 bf16); ``tile_group`` (T / bm,) int32 lies on the device. Needs T, K,
// N, G, bm > 0, T a multiple of bm, contiguous operands, 16-byte aligned
// for f16 / bf16. Returns cudaGetLastError() after the launch (0 =
// launched) on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_gmm(const void* lhs, const void* rhs, const int* tile_group,
                      void* out, int T, int K, int N, int G, int bm,
                      int dtype, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || G <= 0 || bm <= 0 || T % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<SimtGmm>(lhs, rhs, tile_group, out, T, K, N, G, bm, kF32,
                             st);
    case kF16:
      return launch<TcGmm<true>>(lhs, rhs, tile_group, out, T, K, N, G, bm,
                                 kF16, st);
    case kBF16:
      return launch<TcGmm<false>>(lhs, rhs, tile_group, out, T, K, N, G, bm,
                                  kBF16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
