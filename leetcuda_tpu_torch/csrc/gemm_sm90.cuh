// The dense Hopper matmul: out (M, N) = x (M, K) @ B, f16 / bf16 inputs, f32
// sums, one rounding to the output type, in one persistent, warp-
// specialised TMA + wgmma launch. Used by the matmul library (matmul.cu: B
// (K, N) or (N, K) of x's type) and the w8a16 matmul's prefill route
// (wq_matmul.cu: B the weight converted to bf16 beforehand, a per-column
// scale on the f32 sums); the resident chain (matmul_resident.cu) adds its
// reps and flags to the same pieces.
//
// Design:
// - Output tiles of BM x BN (BM 64 or 128: one or two consumer warpgroups
//   of 64 rows) over 64-deep k stages. Thread 0 is the producer: it keeps
//   TMA loads of x (box BM x 64, K-major, 128-byte swizzle) and of B (boxes
//   of 64 x 64: 64 k-rows of 64 columns, MN-major, for B (K, N); 64 rows of
//   64 k, K-major, for B (N, K)) in flight over a ring of kStages stages,
//   each behind a "full" mbarrier that counts the bytes and an "empty" one
//   that the consumer warps arrive on once the wgmma that read the stage
//   has retired. The consumers issue wgmma m64nBNk16 from the stages into
//   f32 registers, one group in flight. setmaxnreg moves registers from the
//   producer warpgroup to the consumers (two consumer warpgroups only).
// - The epilogue: the consumers multiply by the column's scale (w8a16),
//   round to f16 / bf16 into a staging tile in shared memory (the output
//   map's 128-byte swizzled boxes) and go on to their next tile; thread 32,
//   the storer, writes it with TMA stores, which clip at M and N. An f32
//   output is stored from the registers instead (the staging tile would
//   not fit beside the stages).
// - The walk is persistent: ``grid`` CTAs (at most the co-resident count,
//   in whole clusters) take work units b, b + G, b + 2G, ...; unit u is the
//   output tile tile_ij(u) of the grid of units, row-major or, with
//   ``group`` > 0, ``group`` tile-columns at a time (the JAX kernel's
//   _swizzled_ij). With kCluster = 2, CTA pairs along M share a unit (row
//   blocks 2I and 2I + 1 of column block j): each loads half of the B tile
//   and multicasts it to both, its consumers free a stage in both, and its
//   producer leaves only once the pair has freed every stage (clusters of 4
//   the same way).
// - TMA reads 0 past every end, so no value past M, N or K reaches a sum
//   (padding may hold NaN). Row strides must be multiples of 16 bytes (a
//   tensor map's rule): the wrappers pad K and N with zeros, which is exact.
// Every wait is bounded (hopper.cuh kSpinNs): a protocol fault traps.
// bench/gemm_bench.py --hgemm also builds a probe that computes nothing
// right: LC_GEMM_PROBE 1 leaves out the wgmma (the loads, the walk and the
// stores alone).
#pragma once

#include "common.cuh"
#include "dtype.cuh"
#include "hopper.cuh"

#ifndef LC_GEMM_PROBE
#define LC_GEMM_PROBE 0  // bench probe, wrong results: 1 leaves out the wgmma
#endif

namespace lc {

// Linear tile counter t -> output tile (i, j): row-major over an ni x nj
// grid, or, for group > 0, every i of ``group`` columns before the next
// group, the last group narrower when group does not divide nj (the JAX
// kernel's _swizzled_ij; gemm/matmul.py tile_ij is the same formula).
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

namespace sm90 {

__host__ __device__ constexpr int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// What B is: 16-bit values (K, N) (kBkn) or (N, K) (kBnk), or a stack of
// (K, N) panels (G, K, N) read through a 3-D map, one panel a tile
// (kBgkn: the grouped matmul, gmm.cu).
enum BKind { kBkn = 0, kBnk = 1, kBgkn = 2 };

template <int BM_, int BN_, int kStages_, int kCluster_, int kMinCtas_, int kB>
struct GemmPlan {
  static constexpr int BM = BM_, BN = BN_, BK = 64;
  static constexpr int kStages = kStages_, kCluster = kCluster_;
  static constexpr int kMinCtas = kMinCtas_, kKind = kB;
  static constexpr int kCons = BM / 64;   // consumer warpgroups
  static constexpr int kBoxes = BN / 64;  // 64-column boxes of B and out
  static constexpr int THREADS = 128 * (1 + kCons);
  static constexpr int A_BYTES = BM * BK * 2, BOX_BYTES = 64 * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + kBoxes * BOX_BYTES;
  static constexpr int EPI_BOX = BM * 128, EPI_BYTES = kBoxes * EPI_BOX;
  // from a 1024-byte aligned base: the stages, the staging tile, then the
  // full and empty barriers of each stage and the two of the staging tile
  static constexpr int SMEM_BYTES =
      1024 + kStages * STAGE_BYTES + EPI_BYTES + 8 * (2 * kStages + 2);
  // registers a thread after setmaxnreg (two consumer warpgroups): 128 x
  // 40 + 256 x 232 fill the SM's 64 K
  static constexpr int kProdRegs = 40, kConsRegs = 232;
  static_assert(BM == 64 || BM == 128, "BM is 64 or 128");
  static_assert(BN == 64 || BN == 128 || BN == 256, "BN is 64, 128 or 256");
  static_assert(kStages >= 2, "a stage is freed one k step after its use");
  static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4,
                "clusters of 1, 2 or 4 CTAs");
  static_assert(kBoxes % kCluster == 0, "B boxes split over the cluster");
  static_assert(kB != kBgkn || kCluster == 1, "a panel stack: no pairs");
  static_assert(SMEM_BYTES <= 232448, "stages exceed the shared memory");
};

struct GemmMaps {
  CUtensorMap a, b, o;
};

// Two floats rounded to bf16 / f16 in one register, ``lo`` in the low half.
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t f16x2_bits(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------ the pieces of a launch
//
// Shared with the resident chain (matmul_resident.cu), whose walk adds reps
// and flags around the same stages, k loop and staging tile.

// The shared memory of a launch: the stages from a 1024-byte aligned base,
// the staging tile, then the full and empty barriers of each stage and the
// two of the staging tile (consumers staged it / the store has read it).
template <class P>
struct GemmSmem {
  uint8_t* stages;
  uint8_t* epi;
  uint64_t *full, *empty, *epi_full, *epi_empty;
  __device__ explicit GemmSmem(uint8_t* raw)
      : stages(align1024(raw)), epi(stages + P::kStages * P::STAGE_BYTES) {
    full = reinterpret_cast<uint64_t*>(epi + P::EPI_BYTES);
    empty = full + P::kStages;
    epi_full = empty + P::kStages;
    epi_empty = epi_full + 1;
  }
  __device__ uint8_t* stage(int s) const { return stages + s * P::STAGE_BYTES; }
  // one thread, before the launch's first cluster_sync / __syncthreads
  __device__ void init() const {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * P::kCons * P::kCluster);
    }
    mbar_init(epi_full, 128 * P::kCons);
    mbar_init(epi_empty, 1);
    fence_mbar_init();
  }
};

// A walker's place in the ring of stages: stage ``s`` of phase ``ph``.
template <int kStages>
struct RingPos {
  int s = 0;
  uint32_t ph = 0;
  __device__ void next() {
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// The producer's loads of k block ``kb`` of tile (i, j) into stage ``s``,
// once the stage is free: x's box from ``a``, this CTA's share of B's
// boxes from ``b`` (multicast to the pair; of panel ``g`` for kBgkn).
template <class P>
__device__ __forceinline__ void load_stage(const GemmSmem<P>& sm,
                                           RingPos<P::kStages>& pos,
                                           const CUtensorMap* a,
                                           const CUtensorMap* b, int kb, int i,
                                           int j, uint32_t rank, int g = 0) {
  uint64_t* bar = &sm.full[pos.s];
  mbar_wait(&sm.empty[pos.s], pos.ph ^ 1);
  mbar_expect_tx(bar, P::STAGE_BYTES);
  uint8_t* st = sm.stage(pos.s);
  tma_load_2d(st, a, bar, kb * P::BK, i * P::BM);
  auto load_b = [&](void* dst, int c0, int c1) {
    if constexpr (P::kCluster > 1)
      tma_load_2d_multicast(dst, b, bar, c0, c1, (1 << P::kCluster) - 1);
    else
      tma_load_2d(dst, b, bar, c0, c1);
  };
  constexpr int kMine = P::kBoxes / P::kCluster;
#pragma unroll
  for (int q = 0; q < kMine; ++q) {
    const int box = rank * kMine + q;
    uint8_t* dst = st + P::A_BYTES + box * P::BOX_BYTES;
    if constexpr (P::kKind == kBnk)
      load_b(dst, kb * P::BK, j * P::BN + box * 64);
    else if constexpr (P::kKind == kBgkn)
      tma_load_3d(dst, b, bar, j * P::BN + box * 64, kb * P::BK, g);
    else
      load_b(dst, j * P::BN + box * 64, kb * P::BK);
  }
  pos.next();
}

// The pair's consumers arrive on this CTA's barriers and its producer
// multicasts into this CTA's stages: the producer leaves only once every
// stage is free again.
template <class P>
__device__ __forceinline__ void drain(const GemmSmem<P>& sm,
                                      RingPos<P::kStages>& pos) {
  if constexpr (P::kCluster > 1) {
    for (int k = 0; k < P::kStages; ++k) {
      mbar_wait(&sm.empty[pos.s], pos.ph ^ 1);
      pos.next();
    }
  }
}

// A consumer warpgroup's k loop over one tile: rows [64 cw, 64 cw + 64) of
// ``nk`` stages as they fill, wgmma m64nBNk16 into ``acc`` (f32,
// overwritten), one group in flight, each stage freed (in every CTA of the
// pair) once the group that read it has retired.
template <class P, bool kHalf>
__device__ __forceinline__ void mma_tile(float (&acc)[P::BN / 2],
                                         const GemmSmem<P>& sm, int cw,
                                         int nk, RingPos<P::kStages>& pos,
                                         int lane) {
  auto release = [&](int stage) {  // this warp is done with ``stage``
    if (lane == 0) {
      if constexpr (P::kCluster > 1) {
#pragma unroll
        for (int c = 0; c < P::kCluster; ++c)
          mbar_arrive_cluster(&sm.empty[stage], c);
      } else {
        mbar_arrive(&sm.empty[stage]);
      }
    }
  };
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    mbar_wait(&sm.full[pos.s], pos.ph);
    const uint8_t* st = sm.stage(pos.s);
    const uint32_t a0 = smem_u32(st) + cw * 64 * 128;
    const uint32_t b0 = smem_u32(st + P::A_BYTES);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BK / 16; ++kk) {
      // A: 16 values (32 bytes) along k a step. B (K, N): 16 k-rows of 128
      // bytes a step, 64-column boxes BOX_BYTES apart; B (N, K): 32 bytes
      // along k a step, as A
      const uint64_t da = kmajor(a0 + kk * 32);
      if constexpr (LC_GEMM_PROBE == 1)
        continue;
      else if constexpr (P::kKind == kBnk)
        wgmma_ss<kHalf, 0>(acc, da, kmajor(b0 + kk * 32), kb | kk);
      else
        wgmma_ss<kHalf, 1>(acc, da, mnmajor(b0 + kk * 2048, P::BOX_BYTES),
                           kb | kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group before this one has retired
    fence_acc(acc);
    if (prev >= 0) release(prev);
    prev = pos.s;
    pos.next();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release(prev);
}

// A consumer's 64 rows of the tile into the staging tile, as the output
// map's 128-byte swizzled boxes (row t at t * 128, its 16-byte chunk k at
// k ^ (t % 8)): thread (warp, lane) holds rows r and r + 8, columns 8 c +
// 2 (lane % 4) + {0, 1} in acc[4 c + 2 h + {0, 1}]; ``pack(c, x, y)``
// rounds a pair into one 32-bit word.
template <class P, class Pack>
__device__ __forceinline__ void stage_tile(uint8_t* epi,
                                           const float (&acc)[P::BN / 2],
                                           int cw, int warp, int lane,
                                           Pack&& pack) {
  const int r = cw * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < P::BN / 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      *reinterpret_cast<uint32_t*>(
          epi + (c / 8) * P::EPI_BOX + row * 128 +
          (((c % 8) ^ (row % 8)) << 4) + (lane % 4) * 4) =
          pack(c, acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    }
  }
}

// ------------------------------------------------------------ the kernel

template <class P, bool kHalf, bool kScale>
__global__ void __launch_bounds__(P::THREADS, P::kMinCtas)
gemm_sm90(const __grid_constant__ GemmMaps maps,
          const float* __restrict__ scale, float* __restrict__ o32, int M,
          int N, int K, int odt, int group) {
  extern __shared__ uint8_t smem_raw[];
  const GemmSmem<P> sm(smem_raw);
  const int wg = threadIdx.x / 128;
  const uint32_t rank = P::kCluster > 1 ? cluster_ctarank() : 0;
  if (threadIdx.x == 0) sm.init();
  if constexpr (P::kCluster > 1)
    cluster_sync();
  else
    __syncthreads();

  const int nbm = ceil_div(M, P::BM), nbn = ceil_div(N, P::BN);
  const int nk = ceil_div(K, P::BK), ni = ceil_div(nbm, P::kCluster);
  const int units = ni * nbn;
  const int first = blockIdx.x / P::kCluster;
  const int stride = gridDim.x / P::kCluster;
  auto unit_tile = [&](int u, int& i, int& j) {
    int I;
    tile_ij(u, ni, nbn, group, I, j);
    i = I * P::kCluster + rank;
  };

  if (wg == 0) {
    if constexpr (P::kCons > 1) setmaxnreg_dec<P::kProdRegs>();
    if (threadIdx.x == 0) {  // the producer
      prefetch_map(&maps.a);
      prefetch_map(&maps.b);
      RingPos<P::kStages> pos;
      for (int u = first; u < units; u += stride) {
        int i, j;
        unit_tile(u, i, j);
        for (int kb = 0; kb < nk; ++kb)
          load_stage(sm, pos, &maps.a, &maps.b, kb, i, j, rank);
      }
      drain(sm, pos);
    } else if (threadIdx.x == 32) {  // the storer
      if (odt != kF32) prefetch_map(&maps.o);
      uint32_t eph = 0;
      for (int u = first; u < units; u += stride) {
        int i, j;
        unit_tile(u, i, j);
        mbar_wait(sm.epi_full, eph);
        eph ^= 1;
        if (odt != kF32 && i < nbm) {  // rows past M are not written
#pragma unroll
          for (int q = 0; q < P::kBoxes; ++q)
            tma_store_2d(&maps.o, sm.epi + q * P::EPI_BOX,
                         j * P::BN + q * 64, i * P::BM);
          commit_bulk();
          wait_bulk<0, true>();
        }
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
    for (int u = first; u < units; u += stride) {
      int i, j;
      unit_tile(u, i, j);
      mma_tile<P, kHalf>(acc, sm, cw, nk, pos, lane);
      // the epilogue: times the column's scale (N is a multiple of 8, so
      // col + 1 < N where col < N), rounded once
      mbar_wait(sm.epi_empty, eph ^ 1);
      eph ^= 1;
      auto scaled = [&](int c, float& x, float& y) {
        const int col = j * P::BN + 8 * c + 2 * (lane % 4);
        if constexpr (kScale) {
          const float2 sc =
              col < N ? *reinterpret_cast<const float2*>(scale + col)
                      : make_float2(0.f, 0.f);
          x *= sc.x;
          y *= sc.y;
        }
        return col;
      };
      if (odt == kF32) {
        const int r = i * P::BM + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
        for (int c = 0; c < P::BN / 8; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float x = acc[4 * c + 2 * h], y = acc[4 * c + 2 * h + 1];
            const int col = scaled(c, x, y);
            if (r + 8 * h < M && col < N)
              *reinterpret_cast<float2*>(o32 + (size_t)(r + 8 * h) * N +
                                         col) = make_float2(x, y);
          }
      } else {
        stage_tile<P>(sm.epi, acc, cw, warp, lane, [&](int c, float x,
                                                        float y) {
          scaled(c, x, y);
          return odt == kF16 ? f16x2_bits(x, y) : bf16x2_bits(x, y);
        });
      }
      fence_proxy_async_shared();
      mbar_arrive(sm.epi_full);
    }
  }
}

// The host side keeps per-instantiation state in function statics (the
// shared-memory attribute set, the co-resident count), so its functions
// have internal linkage: a function static of an external template is one
// object across every library loaded in the process (a unique symbol), and
// a benchmark loads variant builds of one source side by side.

// The CTAs of ``kern`` that the current device holds at once (clusters
// whole); cached by the caller's ``cached`` (per instantiation and device).
template <class P>
static int gemm_sm90_ctas(const void* kern, int& ctas, int (&cached)[64]) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev < 64 && cached[dev] > 0) {
    ctas = cached[dev];
    return 0;
  }
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (P::kCluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(P::kCluster * sms);
    cfg.blockDim = dim3(P::THREADS);
    cfg.dynamicSmemBytes = P::SMEM_BYTES;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    ctas = clusters * P::kCluster;
  } else {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      P::THREADS,
                                                      P::SMEM_BYTES);
    ctas = per_sm * sms;
  }
  if (e == cudaSuccess && dev < 64) cached[dev] = ctas;
  return static_cast<int>(e);
}

// {BM, BN, BK, stages, cluster, co-resident CTAs} of one instantiation on
// the current device. Returns a CUDA error code.
template <class P, bool kHalf, bool kScale>
static int gemm_sm90_info(int* info) {
  auto kern = gemm_sm90<P, kHalf, kScale>;
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

// One launch of ``grid`` CTAs (a multiple of the cluster, at most the
// co-resident count): out (M, N) of ``odt`` (kF32, kF16, kBF16) = x (M, K)
// @ b (P's kind: kBkn (K, N); kBnk (N, K)), f16 inputs with
// kHalf (else bf16), times scale[col] with kScale. Row strides of x, b and
// a 16-bit out must be multiples of 16 bytes. Returns the CUDA error of the
// launch (0 = launched).
template <class P, bool kHalf, bool kScale>
static int gemm_sm90_launch(const void* x, const void* b,
                            const float* scale, void* o, int M, int N, int K,
                            int odt, int group, int grid, cudaStream_t st) {
  constexpr int kB = P::kKind;
  auto kern = gemm_sm90<P, kHalf, kScale>;
  static unsigned long long attr_devices = 0;
  static int cached[64] = {};
  cudaError_t e = smem_limit_per_device(kern, P::SMEM_BYTES, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = 0;
  if (int err = gemm_sm90_ctas<P>(reinterpret_cast<const void*>(kern), ctas,
                                  cached))
    return err;
  if (grid < P::kCluster || grid % P::kCluster || grid > ctas)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  GemmMaps maps;
  int err = map_2d(&maps.a, x, kHalf, M, K, K, P::BM, P::BK);
  if (!err) {
    if constexpr (kB == kBnk)
      err = map_2d(&maps.b, b, kHalf, N, K, K, 64, P::BK);
    else
      err = map_2d(&maps.b, b, kHalf, K, N, N, P::BK, 64);
  }
  if (!err && odt != kF32)
    err = map_2d(&maps.o, o, odt == kF16, M, N, N, P::BM, 64);
  if (err) return err;

  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(P::THREADS);
  cfg.dynamicSmemBytes = P::SMEM_BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = P::kCluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, maps, scale, static_cast<float*>(o), M,
                         N, K, odt, group);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace lc
