// The resident matmul chain: out = a @ b^reps, b (N, N), rounded to a's
// dtype after every rep (A <- cast(A @ B), ``reps`` times), in one launch.
//
// Replaces: leetcuda_tpu/gemm/matmul.py make_matmul_resident (its
// pallas_call: B resident in VMEM, each row block of A multiplied by B reps
// times in VMEM scratch, written once). B is constant, so row block i
// evolves on its own: C[i] = A[i] B^reps, rounded each rep.
//
// Bound on an H100 SXM: operations (4096^3 bf16, 5 reps: 687 GFLOP, 0.695
// ms at 989 TFLOP/s). Each 128 x 256 output tile streams a 128 x N panel of
// its rep's A and an N x 256 panel of B (3 MiB at N = 4096) out of the L2,
// which holds B (32 MiB at 4096^2 bf16) and the rows in flight.
//
// Design (f16 / bf16), one persistent, warp-specialised launch on the dense
// matmul's pieces (gemm_sm90.cuh: its stages, producer loads, consumer k
// loop and staging tile; the walk, the rep waits and the storer are this
// file's):
// - Tiles of BM x BN (128 x 256 by default) over a K loop of 64-deep
//   stages. Warpgroup 0 is the producer: one thread keeps TMA loads of A
//   (box 128 x 64, K-major) and B (boxes of 64 k-rows x 64 columns,
//   MN-major) in flight over a ring of kStages stages, each behind a "full"
//   mbarrier that counts the bytes and an "empty" one that the consumers
//   arrive on. The two consumer warpgroups (64 rows each) issue wgmma
//   m64nBNk16 from the stages into f32 registers, one wgmma group in
//   flight, and free a stage once the group that read it has retired.
//   setmaxnreg moves registers from the producer to the consumers. Tiles
//   use the 128-byte swizzle.
// - The epilogue: the consumers round the accumulators to f16 / bf16 into
//   a staging tile in shared memory and go on to their next tile; a storer
//   thread of warpgroup 0 writes it to ``out`` or ``scratch`` with TMA
//   stores (which clip at M and N), the rep's parity chosen so that the
//   last rep writes ``out``. (Plain stores and a fence in the consumers
//   held the tensor cores idle at every tile's end.)
// - The walk is persistent: at most one CTA an SM (the grid the wrapper's
//   plan gives, at most the co-resident count; the launch is cooperative,
//   so a grid that cannot be co-resident is refused, never hung). Work
//   units are numbered rep-major, then row block, then column block; CTA
//   (or cluster) b takes units b, b + G, b + 2G, ... A unit's A panel of
//   rep r > 0 is the output rows i of rep r - 1: before loading it the
//   producer spins (ld.acquire.gpu, bounded) until done[r - 1][i] equals
//   the number of column tiles, and once a tile's TMA store has completed
//   the storer bumps done[r][i] (red.release.gpu). A unit waits only on
//   units earlier in the order, so the walk cannot deadlock once every CTA
//   is resident.
// - Rep r + 1 overwrites the rows of the buffer that rep r - 1 wrote. That
//   is safe only because done[r][i], which rep r + 1's tiles of row block i
//   wait on, counts every reader of those rows: the rep-r tiles of row
//   block i, whose TMA loads of them completed before their epilogues.
// - The proxies: rows go out by TMA store and come back by TMA load in
//   another CTA (both the async proxy), ordered through a generic-proxy
//   flag: the storer waits for the store's completion and fences
//   (fence.proxy.async.global, __threadfence) before its release, and the
//   producer fences again after its acquire, before it issues the loads.
//   The consumers' plain stores into the staging tile are fenced
//   (fence.proxy.async.shared::cta) before the storer's TMA reads it.
// - kCluster = 2: CTA pairs along M share the B panel: each CTA loads half
//   of the B boxes and multicasts them to both, its consumers free a stage
//   in both CTAs, and the pair's two row blocks form one work unit.
// - TMA reads 0 past the tensors' ends, so no value past M, N or K reaches
//   a sum (padding may hold NaN). N must be a multiple of 8 (rows of a
//   multiple of 16 bytes, as a tensor map needs): the wrapper pads a and b
//   with zeros to that, which is exact, and slices the result.
// - The counters ``done`` (reps x cdiv(M, BM) ints) must be zero at launch:
//   the wrapper allocates them zeroed every call (no host sync), so two
//   calls in a row and a CUDA-graph replay both start from zero.
// The tile, the stage count and the cluster are the macros below; the
// defaults are what bench/gemm_bench.py --resident chose on an H100. The
// bench also builds two probes, which compute nothing right: LC_RES_PROBE
// 1 leaves out the wgmma (the loads, the walk and the stores alone; the
// same as gemm_sm90.cuh's LC_GEMM_PROBE 1, which it sets), 2 the TMA stores
// too (the loads and the walk).
//
// f32 keeps the CUDA cores (f32 FMA, never TF32): a CTA owns 64 rows for
// every rep, with no grid-wide wait (mm_resident_f32).
#ifndef LC_RES_PROBE
#define LC_RES_PROBE 0
#endif
#if LC_RES_PROBE >= 1 && !defined(LC_GEMM_PROBE)
#define LC_GEMM_PROBE 1
#endif

#include "gemm_sm90.cuh"
#include "mm_tile.cuh"

#ifndef LC_RES_BN
#define LC_RES_BN 256
#endif
#ifndef LC_RES_STAGES
#define LC_RES_STAGES 3
#endif
#ifndef LC_RES_CLUSTER
#define LC_RES_CLUSTER 2
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------- f16 / bf16: TMA + wgmma

using Res = GemmPlan<128, LC_RES_BN, LC_RES_STAGES, LC_RES_CLUSTER, 1, kBkn>;

// The maps: A of rep 0 (``a``), of odd-from-last reps (``scratch``) and of
// the others (``out``), boxes BM x BK; B, boxes BK x 64.
struct Maps {
  CUtensorMap a, out, scratch, b;
};

template <class C, bool kF16>
__global__ void __launch_bounds__(C::THREADS, 1)
mm_resident_tma(const __grid_constant__ Maps maps, int* done, int M, int N,
                int reps) {
  extern __shared__ uint8_t smem_raw[];
  const GemmSmem<C> sm(smem_raw);
  const int wg = threadIdx.x / 128;
  const uint32_t rank = C::kCluster > 1 ? cluster_ctarank() : 0;
  if (threadIdx.x == 0) sm.init();
  if constexpr (C::kCluster > 1)
    cluster_sync();
  else
    __syncthreads();

  const int nbm = cdiv(M, C::BM), nbn = cdiv(N, C::BN), nk = cdiv(N, C::BK);
  const int per_rep = cdiv(nbm, C::kCluster) * nbn;
  const int units = reps * per_rep;
  const int first = blockIdx.x / C::kCluster;
  const int stride = gridDim.x / C::kCluster;
  auto unit = [&](int u, int& r, int& i, int& j) {
    r = u / per_rep;
    const int rem = u % per_rep;
    i = (rem / nbn) * C::kCluster + rank;
    j = rem % nbn;
  };

  if (wg == 0) {  // the producer
    setmaxnreg_dec<C::kProdRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&maps.a);
      prefetch_map(&maps.out);
      prefetch_map(&maps.scratch);
      prefetch_map(&maps.b);
      RingPos<C::kStages> pos;
      for (int u = first; u < units; u += stride) {
        int r, i, j;
        unit(u, r, i, j);
        if (r > 0 && i < nbm) {
          wait_flag_at_least(done + (size_t)(r - 1) * nbm + i, nbn);
          fence_proxy_async_global();
        }
        // rep r reads what rep r - 1 wrote: out if reps - r is even
        const CUtensorMap* src =
            r == 0 ? &maps.a : ((reps - r) & 1) ? &maps.scratch : &maps.out;
        for (int kb = 0; kb < nk; ++kb)
          load_stage(sm, pos, src, &maps.b, kb, i, j, rank);
      }
      drain(sm, pos);
    } else if (threadIdx.x == 32) {  // the storer
      uint32_t eph = 0;
      for (int u = first; u < units; u += stride) {
        int r, i, j;
        unit(u, r, i, j);
        // rep r writes out if reps - 1 - r is even
        const CUtensorMap* dst =
            ((reps - 1 - r) & 1) ? &maps.scratch : &maps.out;
        mbar_wait(sm.epi_full, eph);
        eph ^= 1;
        // rows and columns past M and N are not written
        if (i < nbm && LC_RES_PROBE < 2) {
#pragma unroll
          for (int q = 0; q < C::kBoxes; ++q)
            tma_store_2d(dst, sm.epi + q * C::EPI_BOX, j * C::BN + q * 64,
                         i * C::BM);
          commit_bulk();
          wait_bulk<0, true>();
        }
        mbar_arrive(sm.epi_empty);  // the consumers may stage the next tile
        if (i < nbm) {
          // the rows are in global memory: release them to the CTAs that
          // read them back through TMA
          wait_bulk<0, false>();
          fence_proxy_async_global();
          __threadfence();
          red_release_gpu_add(done + (size_t)r * nbm + i, 1);
        }
      }
    }
  } else {  // a consumer: rows [64 cw, 64 cw + 64) of each tile
    setmaxnreg_inc<C::kConsRegs>();
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    float acc[C::BN / 2];
    RingPos<C::kStages> pos;
    uint32_t eph = 0;
    for (int u = first; u < units; u += stride) {
      mma_tile<C, kF16>(acc, sm, cw, nk, pos, lane);
      // the tile as f16 / bf16 into the staging tile; the storer writes it
      // out with TMA while these warps go on to the next tile
      mbar_wait(sm.epi_empty, eph ^ 1);
      eph ^= 1;
      stage_tile<C>(sm.epi, acc, cw, warp, lane, [](int, float x, float y) {
        return kF16 ? f16x2_bits(x, y) : bf16x2_bits(x, y);
      });
      fence_proxy_async_shared();
      mbar_arrive(sm.epi_full);
    }
  }
}

// The CTAs of the chain's kernel that the current device holds at once
// (clusters whole), its shared-memory limit raised first; cached per
// instantiation and device. cudaErrorNotSupported without cooperative
// launches.
template <class C, bool kF16>
int co_resident_ctas(int& ctas) {
  auto kern = mm_resident_tma<C, kF16>;
  static unsigned long long attr_devices = 0;
  static int cached[64] = {};
  cudaError_t e = smem_limit_per_device(kern, C::SMEM_BYTES, attr_devices);
  int dev = 0, coop = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  return gemm_sm90_ctas<C>(reinterpret_cast<const void*>(kern), ctas, cached);
}

template <class C, bool kF16>
int launch_tma(const void* a, const void* b, void* o, void* scratch,
               int* done, int M, int N, int reps, int grid,
               cudaStream_t st) {
  int ctas = 0;
  if (int err = co_resident_ctas<C, kF16>(ctas)) return err;
  if (grid < C::kCluster || grid % C::kCluster || grid > ctas)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Maps maps;
  int err = map_2d(&maps.a, a, kF16, M, N, N, C::BM, C::BK);
  if (!err) err = map_2d(&maps.out, o, kF16, M, N, N, C::BM, C::BK);
  if (!err) err = map_2d(&maps.scratch, scratch, kF16, M, N, N, C::BM, C::BK);
  if (!err) err = map_2d(&maps.b, b, kF16, N, N, N, C::BK, 64);
  if (err) return err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  int na = 1;
  if constexpr (C::kCluster > 1) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = C::kCluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    na = 2;
  }
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM_BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mm_resident_tma<C, kF16>,
                                           maps, done, M, N, reps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- f32: CUDA cores

constexpr int kF32Rows = 64, kF32Cols = 128;

// A CTA owns kF32Rows rows for every rep, tile by tile across N, so it
// waits on no other CTA; a fence and a barrier between reps make its rows
// visible to all its threads. B is re-read from the L2 every rep.
__global__ void __launch_bounds__((kF32Rows / 4) * (kF32Cols / 8))
mm_resident_f32(const float* a, const float* b, float* out, float* scratch,
                int M, int N, int reps) {
  const int m0 = blockIdx.x * kF32Rows;
  const float* src = a;
  for (int r = 0; r < reps; ++r) {
    float* dst = ((reps - 1 - r) & 1) ? scratch : out;
    for (int n0 = 0; n0 < N; n0 += kF32Cols) {
      __syncthreads();  // the previous tile's reads of smem are done
      simt_tile<float, kF32Rows, kF32Cols, 16, 4, 8, true, false>(
          src, b, dst, M, N, N, kF32, m0, n0);
    }
    __threadfence();
    __syncthreads();
    src = dst;
  }
}

}  // namespace

// The f16 / bf16 chain: o (M, N) = a (M, N) @ b^reps, b (N, N), ``dtype``
// 1 f16 or 2 bf16, rounded after every rep, in one cooperative launch of
// ``grid`` CTAs (a multiple of the cluster, at most the co-resident count:
// lc_matmul_resident_info). ``scratch`` (M, N) holds every other rep's rows
// (may be ``o`` when reps == 1); ``done``: reps * cdiv(M, 128) zeroed ints.
// a and b are never written. Needs M > 0, N > 0 a multiple of 8, reps >= 1,
// contiguous 16-byte aligned operands. Returns the CUDA error of the launch
// (0 = launched) on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_matmul_resident(const void* a, const void* b, void* o,
                                  void* scratch, void* done, int M, int N,
                                  int reps, int dtype, int grid,
                                  void* stream) {
  if (M <= 0 || N <= 0 || N % 8 || reps < 1 || grid < 1 ||
      (dtype != kF16 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* d = static_cast<int*>(done);
  return dtype == kF16
             ? launch_tma<Res, true>(a, b, o, scratch, d, M, N, reps, grid, st)
             : launch_tma<Res, false>(a, b, o, scratch, d, M, N, reps, grid,
                                      st);
}

// What this build launches, for the current device: info = {BM, BN, BK,
// stages, cluster, co-resident CTAs}. Returns a CUDA error code.
extern "C" int lc_matmul_resident_info(int* info) {
  info[0] = Res::BM;
  info[1] = Res::BN;
  info[2] = Res::BK;
  info[3] = Res::kStages;
  info[4] = Res::kCluster;
  return co_resident_ctas<Res, false>(info[5]);
}

// The f32 chain on the CUDA cores: the same contract, cdiv(M, 64) CTAs, any
// N > 0, no counters.
extern "C" int lc_matmul_resident_f32(const void* a, const void* b, void* o,
                                      void* scratch, int M, int N, int reps,
                                      void* stream) {
  if (M <= 0 || N <= 0 || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  mm_resident_f32<<<cdiv(M, kF32Rows), (kF32Rows / 4) * (kF32Cols / 8), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(o), static_cast<float*>(scratch), M, N, reps);
  return static_cast<int>(cudaGetLastError());
}
