// Grouped matmul for Hopper: out (T, N) = lhs (T, K) @ rhs[g] (K, N), where
// row tile i (rows [i bm, (i + 1) bm)) takes the expert panel
// g = tile_group[i]; summed in f32 and rounded once to lhs's dtype (f32,
// f16 or bf16).
//
// Replaces: leetcuda_tpu/gemm/grouped.py make_gmm (_gmm_kernel, whose
// scalar-prefetched tile_group steers each row tile's rhs BlockSpec). Here
// the kernel reads each tile's expert id from device memory; nothing goes
// through the host, so the caller's routing stays on the device. An expert
// id outside [0, G) writes NaN over its tile rather than read past rhs.
// Every tile is computed, the MoE buffer's zero padding rows and dead tiles
// too: that is the function the TPU kernel computes.
//
// Bound on an H100 SXM, at Qwen3-30B-A3B's shapes (K / N 2048 / 768): bytes
// at decode (a B=8 step's 16512-row buffer and the ~54 expert panels of
// 3 MB it touches: 0.078 ms at 3.35 TB/s, while all its rows' 52 GFLOP take
// 0.053 ms at 989 TFLOP/s); operations at an 8 x 1024 prefill (81920 rows:
// 258 GFLOP, 0.26 ms, the bytes about as long).
//
// Two routes (gemm/grouped.py gmm_plan picks one):
// - "wgmma" (lc_gmm_sm90), f16 / bf16 with bm a multiple of 64 and K, N
//   multiples of 8 (a tensor map's 16-byte row strides): the dense
//   matmul's persistent, warp-specialised TMA + wgmma pieces
//   (gemm_sm90.cuh). A unit is an output tile (i, j) of BM x BN, BM (128,
//   or 64 where bm is not a multiple of 128) dividing bm, so a unit lies in
//   one row tile; the producer thread and the consumers read its expert
//   g = tile_group[i BM / bm] on the device. x comes through a 2-D map over
//   (T, K) in BM x 64 boxes, K-major; the expert's panel through a 3-D map
//   over rhs (G, K, N) in 64 x 64 x 1 boxes, MN-major, so that a k box
//   never reads the next expert's rows and TMA's zero fill covers K % 64;
//   the output through the storer's TMA stores from the staging tile. One
//   CTA an SM walks the units N fastest within a row tile (tile_ij, group
//   LC_GMM_GROUP = 0), so that the CTAs of a row tile and the row tiles of
//   an expert after them read one panel while it sits in L2. No CTA pairs
//   along M: two row tiles may belong to two experts. A unit of an
//   out-of-range expert gets no loads and its consumers stage NaN, producer
//   and consumers skipping it in step so that no barrier phase is lost.
// - "tile" (lc_gmm), every other call (f32, bm of 8-32, a ragged N or K):
//   the dense library's old tiles (mm_tile.cuh), one CTA a 128 x 128 output
//   tile; f16 / bf16 on mma.sync, f32 on the CUDA cores (8 x 8 register
//   blocks, double-buffered), no TF32. A CTA owns rows of one row tile only
//   (a row tile of bm rows is cut into ceil(bm / 128) CTA row blocks, the
//   last one shorter), so a CTA never straddles two experts.
#include "gemm_sm90.cuh"
#include "mm_tile.cuh"

namespace {

using namespace lc;
using namespace lc::sm90;

// ------------------------------------------------------ the wgmma route

// The 128-row tile's width and stages and the walk's group. The package
// builds the defaults; bench/gemm_bench.py --gmm builds its A/B's variants
// (a 128 x 128 tile of 6 stages; group 1, a tile column at a time).
#ifndef LC_GMM_BN
#define LC_GMM_BN 256
#endif
#ifndef LC_GMM_STAGES
#define LC_GMM_STAGES 3
#endif
#ifndef LC_GMM_GROUP
#define LC_GMM_GROUP 0
#endif

// (BM, BN, stages, cluster, CTAs an SM), B a stack of (K, N) panels. The
// tile ids are gemm/grouped.py's GMM_TILES keys.
using Wg128 = GemmPlan<128, LC_GMM_BN, LC_GMM_STAGES, 1, 1, kBgkn>;
using Wg64 = GemmPlan<64, 128, 3, 1, 2, kBgkn>;
enum Tile { kWg128 = 0, kWg64 = 1 };

template <class P, bool kHalf>
__global__ void __launch_bounds__(P::THREADS, P::kMinCtas)
gmm_sm90(const __grid_constant__ GemmMaps maps,
         const int* __restrict__ tile_group, int T, int N, int K, int G,
         int bm) {
  extern __shared__ uint8_t smem_raw[];
  const GemmSmem<P> sm(smem_raw);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) sm.init();
  __syncthreads();

  const int nbm = T / P::BM, nbn = ceil_div(N, P::BN);
  const int nk = ceil_div(K, P::BK), units = nbm * nbn;
  const int per_tile = bm / P::BM;  // row blocks a row tile
  // the expert of row block i: that of the row tile holding it, or -1
  auto expert = [&](int i) {
    const int g = __ldg(tile_group + i / per_tile);
    return (g >= 0 && g < G) ? g : -1;
  };

  if (wg == 0) {
    if constexpr (P::kCons > 1) setmaxnreg_dec<P::kProdRegs>();
    if (threadIdx.x == 0) {  // the producer
      prefetch_map(&maps.a);
      prefetch_map(&maps.b);
      RingPos<P::kStages> pos;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int i, j;
        tile_ij(u, nbm, nbn, LC_GMM_GROUP, i, j);
        const int g = expert(i);
        if (g < 0) continue;  // no loads: the consumers stage NaN
        for (int kb = 0; kb < nk; ++kb)
          load_stage(sm, pos, &maps.a, &maps.b, kb, i, j, 0, g);
      }
    } else if (threadIdx.x == 32) {  // the storer
      prefetch_map(&maps.o);
      uint32_t eph = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        int i, j;
        tile_ij(u, nbm, nbn, LC_GMM_GROUP, i, j);
        mbar_wait(sm.epi_full, eph);
        eph ^= 1;
#pragma unroll
        for (int q = 0; q < P::kBoxes; ++q)
          tma_store_2d(&maps.o, sm.epi + q * P::EPI_BOX, j * P::BN + q * 64,
                       i * P::BM);
        commit_bulk();
        wait_bulk<0, true>();
        mbar_arrive(sm.epi_empty);  // the consumers may stage the next tile
      }
      wait_bulk<0, false>();
    }
  } else {  // a consumer: rows [64 cw, 64 cw + 64) of each tile
    if constexpr (P::kCons > 1) setmaxnreg_inc<P::kConsRegs>();
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    float acc[P::BN / 2];
    RingPos<P::kStages> pos;
    uint32_t eph = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int i, j;
      tile_ij(u, nbm, nbn, LC_GMM_GROUP, i, j);
      const bool dead = expert(i) < 0;  // NaN over the tile, no products
      if (!dead) mma_tile<P, kHalf>(acc, sm, cw, nk, pos, lane);
      mbar_wait(sm.epi_empty, eph ^ 1);
      eph ^= 1;
      stage_tile<P>(sm.epi, acc, cw, warp, lane, [&](int, float x, float y) {
        const float nan = __int_as_float(0x7fc00000);
        return kHalf ? f16x2_bits(dead ? nan : x, dead ? nan : y)
                     : bf16x2_bits(dead ? nan : x, dead ? nan : y);
      });
      fence_proxy_async_shared();
      mbar_arrive(sm.epi_full);
    }
  }
}

// The host side keeps per-instantiation state in function statics, so its
// functions have internal linkage (gemm_sm90.cuh says why).
template <class P, bool kHalf>
static int wg_info(int* info) {
  auto kern = gmm_sm90<P, kHalf>;
  static unsigned long long attr_devices = 0;
  static int cached[64] = {};
  info[0] = P::BM;
  info[1] = P::BN;
  info[2] = P::BK;
  info[3] = P::kStages;
  info[4] = P::kCluster;
  const cudaError_t e =
      smem_limit_per_device(kern, P::SMEM_BYTES, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  return gemm_sm90_ctas<P>(reinterpret_cast<const void*>(kern), info[5],
                           cached);
}

template <class P, bool kHalf>
static int wg_launch(const void* lhs, const void* rhs, const int* tile_group,
                     void* out, int T, int K, int N, int G, int bm, int grid,
                     cudaStream_t st) {
  auto kern = gmm_sm90<P, kHalf>;
  int info[7];
  if (int err = wg_info<P, kHalf>(info)) return err;
  if (bm % P::BM || grid < 1 || grid > info[5])
    return static_cast<int>(cudaErrorInvalidConfiguration);
  GemmMaps maps;
  int err = map_2d(&maps.a, lhs, kHalf, T, K, K, P::BM, P::BK);
  if (!err) err = map_3d(&maps.b, rhs, kHalf, G, K, N, P::BK, 64);
  if (!err) err = map_2d(&maps.o, out, kHalf, T, N, N, P::BM, 64);
  if (err) return err;
  kern<<<grid, P::THREADS, P::SMEM_BYTES, st>>>(maps, tile_group, T, N, K, G,
                                                bm);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHalf>
int wg_dispatch(int tile, const void* lhs, const void* rhs,
                const int* tile_group, void* out, int T, int K, int N, int G,
                int bm, int grid, cudaStream_t st) {
  switch (tile) {
    case kWg128:
      return wg_launch<Wg128, kHalf>(lhs, rhs, tile_group, out, T, K, N, G,
                                     bm, grid, st);
    case kWg64:
      return wg_launch<Wg64, kHalf>(lhs, rhs, tile_group, out, T, K, N, G, bm,
                                    grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ------------------------------------------------------- the tile route

// The tensor-core tile: 128 x 128, 8 warps 2 x 4, 3 stages (matmul.cu's
// old Tc128).
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

template <class Step>
int tile_launch(const void* lhs, const void* rhs, const int* tile_group,
                void* out, int T, int K, int N, int G, int bm, int odt,
                cudaStream_t st) {
  using E = typename Step::E;
  auto kern = gmm_kernel<Step>;
  static unsigned long long attr_devices = 0;  // per instantiation
  if (Step::SMEM_BYTES > 0) {
    const cudaError_t e =
        lc::smem_limit_per_device(kern, Step::SMEM_BYTES, attr_devices);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = (long long)(T / bm) * ceil_div(bm, Step::BM) *
                         ceil_div(N, Step::BN);
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (K % 8 == 0) && (N % 8 == 0);
  kern<<<static_cast<unsigned>(grid), Step::THREADS, Step::SMEM_BYTES, st>>>(
      static_cast<const E*>(lhs), static_cast<const E*>(rhs), tile_group, out,
      K, N, G, bm, odt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points: out (T, N) = row tile i of lhs (T, K) @
// rhs[tile_group[i]] (K, N), for the T / bm row tiles. ``dtype`` is lhs's,
// rhs's and out's (0 f32, 1 f16, 2 bf16); ``tile_group`` (T / bm,) int32
// lies on the device. Need T, K, N, G, bm > 0, T a multiple of bm,
// contiguous operands, 16-byte aligned for f16 / bf16. Return
// cudaGetLastError() after the launch (0 = launched) on ``stream``; do not
// synchronise and allocate nothing.

// The tile route: any of the three dtypes, any bm, K and N.
extern "C" int lc_gmm(const void* lhs, const void* rhs, const int* tile_group,
                      void* out, int T, int K, int N, int G, int bm,
                      int dtype, void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || G <= 0 || bm <= 0 || T % bm != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return tile_launch<SimtGmm>(lhs, rhs, tile_group, out, T, K, N, G, bm,
                                  kF32, st);
    case kF16:
      return tile_launch<TcGmm<true>>(lhs, rhs, tile_group, out, T, K, N, G,
                                      bm, kF16, st);
    case kBF16:
      return tile_launch<TcGmm<false>>(lhs, rhs, tile_group, out, T, K, N, G,
                                       bm, kBF16, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wgmma route: f16 / bf16, K and N multiples of 8, bm a multiple of the
// tile's BM; ``tile`` the instantiation (Tile above), ``grid`` CTAs (at
// most the co-resident count, lc_gmm_sm90_info).
extern "C" int lc_gmm_sm90(const void* lhs, const void* rhs,
                           const int* tile_group, void* out, int T, int K,
                           int N, int G, int bm, int dtype, int tile, int grid,
                           void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || G <= 0 || bm <= 0 || T % bm != 0 ||
      K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF16)
    return wg_dispatch<true>(tile, lhs, rhs, tile_group, out, T, K, N, G, bm,
                             grid, st);
  if (dtype == kBF16)
    return wg_dispatch<false>(tile, lhs, rhs, tile_group, out, T, K, N, G,
                              bm, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// What wgmma ``tile`` launches on the current device: info = {BM, BN, BK,
// stages, cluster, co-resident CTAs, the walk's group} (the bf16 build; f16
// shares the tile and the shared memory). Returns a CUDA error code.
extern "C" int lc_gmm_sm90_info(int tile, int* info) {
  info[6] = LC_GMM_GROUP;
  switch (tile) {
    case kWg128:
      return wg_info<Wg128, false>(info);
    case kWg64:
      return wg_info<Wg64, false>(info);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
