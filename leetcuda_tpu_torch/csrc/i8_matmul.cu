// Exact int8 matmul for Hopper: out (M, N) int32 = x (M, K) int8 @
// w (K, N) int8, summed in int32 (exact: |sum| <= K * 128^2 < 2^31 for
// K < 2^17).
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_i8i8i32 (_i8_mm_kernel),
// the registry's hgemm_w8a8_i32 (atol 0).
//
// Bound on an H100 SXM: operations, at 1979 TOP/s int8 on the tensor cores
// (8192^3: 1.1 TOP, 0.56 ms). Design: the dense matmul's persistent,
// warp-specialised TMA + wgmma kernel (gemm_sm90.cuh: its ring of stages,
// load_stage, the grouped tile walk, CTA pairs sharing B by multicast) with
// wgmma.m64nBNk32.s32.s8.s8 into int32 registers:
// - wgmma takes 8-bit A and B from shared memory only K-major (the
//   transpose bits exist for 16-bit types alone), and w is (K, N) row-major,
//   N-major. So the call is two launches: i8_transpose writes w^T (N, K)
//   into a scratch the wrapper keeps per stream (128 MB moved at 8192^2,
//   about 0.04 ms at the memory rate), then the product reads x and w^T
//   K-major by TMA (boxes of 128 rows of 128 bytes, the 128-byte swizzle:
//   one swizzled row is 128 k, four wgmma k32 steps a stage). TMA reads 0
//   past M, N and K, which is exact for a sum.
// - Output tiles of 128 x BN (two consumer warpgroups of 64 rows; BN 256:
//   128 int32 accumulators a thread, setmaxnreg moving registers from the
//   producer warpgroup) over a ring of kStages stages, one wgmma group in
//   flight. The int32 tile does not fit beside the stages as a staging tile
//   (128 KB), so the consumers store it from registers (8 bytes a thread,
//   each 32-byte sector whole) and go on to their next tile while the
//   producer already fills the ring for it.
// The variants (LC_I8_BN, LC_I8_STAGES, LC_I8_CLUSTER) and a probe that
// computes nothing right (LC_I8_PROBE 1: no wgmma, the loads, the walk and
// the stores alone) are the A/B of bench/gemm_bench.py --i8.
#include "gemm_sm90.cuh"

#ifndef LC_I8_BN
#define LC_I8_BN 256
#endif
#ifndef LC_I8_STAGES
#define LC_I8_STAGES 4
#endif
#ifndef LC_I8_CLUSTER
#define LC_I8_CLUSTER 2
#endif
#ifndef LC_I8_PROBE
#define LC_I8_PROBE 0
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

// What load_stage and GemmSmem read of a plan (gemm_sm90.cuh GemmPlan), for
// bytes: a stage is x's 128 x 128-byte box and BN / 64 boxes of 64 rows of
// w^T, 128 bytes each.
template <int BN_, int kStages_, int kCluster_>
struct I8Plan {
  static constexpr int BM = 128, BN = BN_, BK = 128;
  static constexpr int kStages = kStages_, kCluster = kCluster_;
  static constexpr int kKind = kBnk, kCons = 2, kBoxes = BN / 64;
  static constexpr int THREADS = 128 * (1 + kCons);
  static constexpr int A_BYTES = BM * BK, BOX_BYTES = 64 * BK;
  static constexpr int STAGE_BYTES = A_BYTES + kBoxes * BOX_BYTES;
  static constexpr int EPI_BYTES = 0;  // the output goes from registers
  static constexpr int SMEM_BYTES =
      1024 + kStages * STAGE_BYTES + 8 * (2 * kStages + 2);
  static constexpr int kProdRegs = 40, kConsRegs = 232;
  static_assert(BN == 128 || BN == 256, "BN is 128 or 256");
  static_assert(kCluster == 1 || kCluster == 2, "clusters of 1 or 2 CTAs");
  static_assert(SMEM_BYTES <= 232448, "stages exceed the shared memory");
};

using Plan = I8Plan<LC_I8_BN, LC_I8_STAGES, LC_I8_CLUSTER>;

// D (64 x N, s32) (+)= A (64 x 32 bytes, K-major) @ B (32 x N, K-major),
// signed bytes; ``acc`` 0 overwrites D. The register layout is the f32
// one: thread t holds rows 16 (t / 32) + (t % 32) / 4 + 8 h, columns 8 c +
// 2 (t % 4) + e in d[4 c + 2 h + e].
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n\t}"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
        "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

template <int N>
__device__ __forceinline__ void fence_acc_i(int (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// A consumer warpgroup's k loop over one tile: rows [64 cw, 64 cw + 64) of
// ``nk`` stages as they fill, four k32 steps a stage into ``acc``
// (overwritten), one group in flight, each stage freed (in every CTA of the
// pair) once the group that read it has retired.
template <class P>
__device__ __forceinline__ void mma_tile_i8(int (&acc)[P::BN / 2],
                                            const GemmSmem<P>& sm, int cw,
                                            int nk, RingPos<P::kStages>& pos,
                                            int lane) {
  auto release = [&](int stage) {
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
    fence_acc_i(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P::BK / 32; ++kk) {
      if constexpr (LC_I8_PROBE == 1) {
        if (kb == 0 && kk == 0)
#pragma unroll
          for (int i = 0; i < P::BN / 2; ++i) acc[i] = 0;
      } else {
        wgmma_s8(acc, kmajor(a0 + kk * 32), kmajor(b0 + kk * 32), kb | kk);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the group before this one has retired
    fence_acc_i(acc);
    if (prev >= 0) release(prev);
    prev = pos.s;
    pos.next();
  }
  wgmma_wait<0>();
  fence_acc_i(acc);
  release(prev);
}

struct I8Maps {
  CUtensorMap a, b;
};

template <class P>
__global__ void __launch_bounds__(P::THREADS, 1)
i8_sm90(const __grid_constant__ I8Maps maps, int32_t* __restrict__ o, int M,
        int N, int K, int group) {
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
    setmaxnreg_dec<P::kProdRegs>();
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
    }
  } else {  // a consumer: rows [64 cw, 64 cw + 64) of each tile
    setmaxnreg_inc<P::kConsRegs>();
    const int cw = wg - 1, warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    int acc[P::BN / 2];
    RingPos<P::kStages> pos;
    for (int u = first; u < units; u += stride) {
      int i, j;
      unit_tile(u, i, j);
      mma_tile_i8<P>(acc, sm, cw, nk, pos, lane);
      // rows past M (the pair's second row block past the end too) are not
      // written; N is a multiple of 16, so col + 1 < N where col < N
      const int r = i * P::BM + cw * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < P::BN / 8; ++c) {
        const int col = j * P::BN + 8 * c + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r + 8 * h < M && col < N)
            *reinterpret_cast<int2*>(o + (size_t)(r + 8 * h) * N + col) =
                make_int2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
      }
    }
  }
}

// w (K, N) -> wt (N, K), bytes, K and N multiples of 16: a CTA takes 64
// k-rows by 128 columns; each thread reads 4 x 4 blocks with 4-byte loads
// (a warp: 128 bytes of one row), transposes them in registers and writes
// columns of 4 k into shared memory, then writes rows of wt 16 bytes at a
// time.
constexpr int TK = 64, TN = 128, TLD = TK + 16;  // bytes a shared row

__global__ void __launch_bounds__(256)
i8_transpose(const int8_t* __restrict__ w, int8_t* __restrict__ wt, int K,
             int N) {
  __shared__ __align__(16) uint8_t tile[TN * TLD];  // [n][k]
  const int k0 = blockIdx.y * TK, n0 = blockIdx.x * TN;
#pragma unroll
  for (int it = 0; it < (TK / 4) * (TN / 4) / 256; ++it) {
    const int b = threadIdx.x + it * 256, kb = b / (TN / 4), nb = b % (TN / 4);
    const int k = k0 + 4 * kb, n = n0 + 4 * nb;
    uint32_t r[4] = {0u, 0u, 0u, 0u};
    if (k < K && n < N)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        r[q] = *reinterpret_cast<const uint32_t*>(w + (size_t)(k + q) * N + n);
    // rows k .. k+3 (4 columns each) -> columns n .. n+3 (4 k each)
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t u0 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t u1 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t cols[4] = {__byte_perm(t0, u0, 0x5410),
                              __byte_perm(t0, u0, 0x7632),
                              __byte_perm(t1, u1, 0x5410),
                              __byte_perm(t1, u1, 0x7632)};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<uint32_t*>(tile + (4 * nb + q) * TLD + 4 * kb) =
          cols[q];
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < TN * (TK / 16) / 256; ++it) {
    const int c = threadIdx.x + it * 256, n = c / (TK / 16),
              kc = (c % (TK / 16)) * 16;
    if (n0 + n < N && k0 + kc < K)
      *reinterpret_cast<uint4*>(wt + (size_t)(n0 + n) * K + k0 + kc) =
          *reinterpret_cast<const uint4*>(tile + n * TLD + kc);
  }
}

}  // namespace

// w (K, N) int8 -> wt (N, K), K and N positive multiples of 16, both
// 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int lc_i8_transpose(const void* w, void* wt, int K, int N,
                               void* stream) {
  if (K <= 0 || N <= 0 || K % 16 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TN - 1) / TN, (K + TK - 1) / TK);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  i8_transpose<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N);
  return static_cast<int>(cudaGetLastError());
}

// {BM, BN, BK, stages, cluster, co-resident CTAs on the current device,
// shared-memory bytes, probe} of the build. Returns a CUDA error code.
extern "C" int lc_i8_info(int* info) {
  auto kern = i8_sm90<Plan>;
  static unsigned long long attr_devices = 0;
  static int cached[64] = {};
  info[0] = Plan::BM;
  info[1] = Plan::BN;
  info[2] = Plan::BK;
  info[3] = Plan::kStages;
  info[4] = Plan::kCluster;
  info[6] = Plan::SMEM_BYTES;
  info[7] = LC_I8_PROBE;
  const cudaError_t e =
      smem_limit_per_device(kern, Plan::SMEM_BYTES, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  return gemm_sm90_ctas<Plan>(reinterpret_cast<const void*>(kern), info[5],
                              cached);
}

// out (M, N) int32 = x (M, K) int8 @ wt (N, K) int8 ^T in one persistent
// launch of ``grid`` CTAs (whole clusters, at most the co-resident count),
// tile columns walked ``group`` at a time (0: row-major). M > 0, K and N
// positive multiples of 16, operands 16-byte aligned. Launches on
// ``stream``; allocates nothing. Returns the CUDA error of the launch.
extern "C" int lc_i8_matmul(const void* x, const void* wt, void* o, int M,
                            int N, int K, int group, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = i8_sm90<Plan>;
  static unsigned long long attr_devices = 0;
  static int cached[64] = {};
  cudaError_t e = smem_limit_per_device(kern, Plan::SMEM_BYTES, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = 0;
  if (int err = gemm_sm90_ctas<Plan>(reinterpret_cast<const void*>(kern),
                                     ctas, cached))
    return err;
  if (grid < Plan::kCluster || grid % Plan::kCluster || grid > ctas)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  I8Maps maps;
  int err = map_2d_u8(&maps.a, x, M, K, K, Plan::BM, Plan::BK);
  if (!err) err = map_2d_u8(&maps.b, wt, N, K, K, 64, Plan::BK);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Plan::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(Plan::THREADS);
  cfg.dynamicSmemBytes = Plan::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = Plan::kCluster > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, maps, static_cast<int32_t*>(o), M, N, K,
                         group);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
