// Weight-only int4 matmul, w4a16, for Hopper: out (M, N) bf16 =
// x (M, K) bf16 @ dequant(packed (K/2, N) int8, scales (K/128, N) f32).
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_w4a16 (_w4_mm_kernel).
// The pack is SPLIT-HALVES (quantize_groupwise_int4): packed byte i holds
// W row i in the low nibble, biased by +8, and row K/2 + i in the high
// nibble, two's complement. Scales are per group of 128 rows and fold past
// each group's dot, as on the TPU: for packed group g, a = x[:, g-cols] @
// lo and b = x[:, K/2 + g-cols] @ hi accumulate in f32, then
// acc += a * s[g] + b * s[g + K/256]. (Folding the scale into bf16 weights
// would round q * s to bf16: a different, lossier function.)
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes at decode
// (M=8, K=2048, N=5632: 6.2 MB, 1.9 us); operations at prefill (M=1024,
// K=2048, N=5632: 23.6 GFLOP, 24 us).
//
// Design: the swapped product out^T = W^T x^T on wgmma, one kernel for
// every row count.
// * A CTA is two warpgroups (256 threads) and owns 128 output columns (64
//   a warpgroup, the wgmma's M) by BM rows (the wgmma's N: 8, 16, 32 or 64
//   at decode rows, 64 or LC_W4_PREFILL_M at prefill rows; the wrapper's
//   w4_plan picks them by M). M in the N slot is
//   what lets 8 decode rows use a 64 x 8 product instead of wasting most of
//   an m64 tile, and it needs no unpacked weight tile in shared memory.
// * TMA feeds a ring of stages (hopper.cuh ``Ring``; the warp whose release
//   completes a stage issues its next load): per stage 64 packed rows x 128
//   columns (8 KB, 128-byte swizzle) and the two x tiles, columns k0.. and
//   K/2 + k0.. (BM x 64 bf16 each, K-major, the B operand).
// * Each thread unpacks its A fragments (W^T, n x k) straight from the
//   packed tile: two 16-bit loads (rows k and k + 1, its two adjacent
//   columns) give the low nibbles' and the high nibbles' bf16x2 pairs for
//   both of its fragment rows, exactly, by the bf16 bit trick (0x4300 | u is
//   128 + u; minus 136 gives u - 8; the high nibble is xor-ed with 8 first:
//   (u ^ 8) - 8 is its two's-complement value). The fragment's rows are
//   permuted over the columns (row g + 8h of a warp is column 2g + h of its
//   16) so that both come from one 16-bit word; the 128-byte swizzle keeps
//   the loads of a warp on distinct banks.
// * Per 16 packed rows a warpgroup issues two RS wgmma (low half into the
//   group's accumulator a, high half into b) and unpacks the next step's
//   fragments while they run (two fragment sets). At a group's end it waits
//   and folds a * s_lo + b * s_hi into the output accumulator in f32; the
//   output is rounded to bf16 once.
// * Split-K: the wrapper may cut K into splits of whole groups (grid.z).
//   Each split writes its f32 partial to a workspace; the last CTA of an
//   output tile to finish (a counter the wrapper keeps zeroed and the CTA
//   zeroes again) sums the partials in split order and writes the tile:
//   one launch, no float atomics, the same bits on every call. The wrapper
//   splits at decode rows (to put enough bytes in flight on every SM) and
//   not at prefill rows.
#include "common.cuh"
#include "hopper.cuh"

#ifndef LC_W4_PREFILL_M
#define LC_W4_PREFILL_M 128  // rows of a prefill CTA (the wgmma's N)
#endif
#ifndef LC_W4_STAGES
#define LC_W4_STAGES 4
#endif
#ifndef LC_W4_PROBE
#define LC_W4_PROBE 0  // bench probes, wrong results: 1 no unpack, 2 no wgmma
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

constexpr int kGroup = 128;      // packed rows of a scale group
constexpr int kStageRows = 64;   // packed rows of a stage: half a group
constexpr int kSteps = kStageRows / 16;  // k16 steps of a stage
constexpr int kBN = 128;         // output columns of a CTA
constexpr int kThreads = 256;
constexpr int kStages = LC_W4_STAGES;
static_assert(kStages >= 2, "a stage is released one step after its last");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <int BM>
struct W4Tile {
  static constexpr int P_BYTES = kStageRows * kBN;  // packed, 8 KB
  static constexpr int X_BYTES = BM * 128;          // an x tile: BM x 64
  static constexpr int STAGE_BYTES = P_BYTES + 2 * X_BYTES;
  // from a 1024-byte aligned base: the stages, then kStages mbarriers,
  // kStages release counters and the last-CTA flag
  static constexpr int SMEM_BYTES =
      1024 + kStages * STAGE_BYTES + 16 * kStages + 16;
  static_assert(BM % 8 == 0 && BM <= 256, "wgmma N");
  static_assert(SMEM_BYTES <= 232448, "w4a16 stages exceed the shared memory");
};

struct Maps {
  CUtensorMap x, packed;
};

// bf16x2 a - b, exact on the small integers here.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t y;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(y) : "r"(a), "r"(b));
  return y;
}

// The low-half and high-half A fragments of k16 step ``kk`` of the packed
// tile ``pk`` for this thread (warp ``w`` of warpgroup ``c``, g, t): a[2 j +
// h] holds k rows 16 kk + 8 j + 2 t, + 1 (low half first) of column 64 c +
// 16 w + 2 g + h.
__device__ __forceinline__ void unpack_step(const uint8_t* pk, int kk, int c,
                                            int w, int g, int t,
                                            uint32_t (&lo)[4],
                                            uint32_t (&hi)[4]) {
  if (LC_W4_PROBE == 1) {  // the products on a fixed fragment
#pragma unroll
    for (int i = 0; i < 4; ++i) lo[i] = hi[i] = 0x3F803F80u ^ (kk + i);
    return;
  }
  const int chunk = 4 * c + w;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 16 * kk + 8 * j + 2 * t;
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(
        pk + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * g);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
        pk + (r + 1) * 128 + ((chunk ^ ((r + 1) & 7)) << 4) + 2 * g);
    const uint32_t u = w0 | (w1 << 16);  // (r, n0) (r, n1) (r+1, n0) (r+1, n1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = __byte_perm(u, 0u, h ? 0x4341 : 0x4240);
      lo[2 * j + h] =
          sub_bf16x2((v & 0x000F000Fu) | 0x43004300u, 0x43084308u);
      hi[2 * j + h] =
          sub_bf16x2(((v >> 4) & 0x000F000Fu) ^ 0x43084308u, 0x43084308u);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
w4_mm_kernel(const __grid_constant__ Maps maps, const float* __restrict__ scales,
             uint16_t* __restrict__ o, float* __restrict__ ws,
             int* __restrict__ counters, int M, int N, int K) {
  using T = W4Tile<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kStages * T::STAGE_BYTES);
  int* released = reinterpret_cast<int*>(full + kStages);
  int* last_flag = released + kStages;
  const Ring<kStages, 8> ring{full, released};

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, sp = blockIdx.z;
  const int Kh = K / 2, groups = Kh / kGroup;
  const int gps = cdiv(groups, splits);
  const int g_lo = sp * gps, g_hi = min(groups, g_lo + gps);
  const int n_stages = (g_hi - g_lo) * (kGroup / kStageRows);
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i, int s, uint64_t* bar) {
    mbar_expect_tx(bar, T::STAGE_BYTES);
    uint8_t* st = stages + s * T::STAGE_BYTES;
    const int kp = g_lo * kGroup + i * kStageRows;
    tma_load_2d(st, &maps.packed, bar, n0, kp);
    tma_load_2d(st + T::P_BYTES, &maps.x, bar, kp, m0);
    tma_load_2d(st + T::P_BYTES + T::X_BYTES, &maps.x, bar, Kh + kp, m0);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&maps.x);
    prefetch_map(&maps.packed);
    ring.start(n_stages, issue);
  }

  // this thread's columns n, n + 1 (fragment rows g, g + 8)
  const int n = n0 + 64 * c + 16 * warp + 2 * g;
  float acc[BM / 2], ga[BM / 2], gb[BM / 2];
  zero(acc);
  zero(ga);
  zero(gb);
  uint32_t fr[2][2][4];  // [step parity][low, high half][register]
  float2 sl = make_float2(0.f, 0.f), sh = sl;  // the group's scales
  ring.wait(0);
  unpack_step(stages, 0, c, warp, g, t, fr[0][0], fr[0][1]);
  for (int i = 0; i < n_stages; ++i) {
    uint8_t* st = stages + (i % kStages) * T::STAGE_BYTES;
    const uint32_t xl = smem_u32(st + T::P_BYTES);
    const uint32_t xh = xl + T::X_BYTES;
    const bool group_end = i % 2 == 1;
    if (!group_end && n < N) {  // loaded now, folded at the group's end
      const int grp = g_lo + i / 2;
      sl = *reinterpret_cast<const float2*>(scales + (size_t)grp * N + n);
      sh = *reinterpret_cast<const float2*>(scales +
                                            (size_t)(grp + groups) * N + n);
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const int first = i % 2 == 0 && kk == 0;  // a group's first product
      fence_acc(ga);
      fence_acc(gb);
      wgmma_fence();
      if (LC_W4_PROBE != 2) {
        wgmma_rs_bf16<0>(ga, fr[kk & 1][0], kmajor(xl + kk * 32), !first);
        wgmma_rs_bf16<0>(gb, fr[kk & 1][1], kmajor(xh + kk * 32), !first);
      }
      wgmma_commit();
      if (group_end && kk == kSteps - 1) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<1>();  // the previous step: its fragments are free
      }
      fence_acc(ga);
      fence_acc(gb);
      fence_frag(fr[0]);
      fence_frag(fr[1]);
      // stage i - 1 is read once step 0 of stage i waited on its last step
      if (kk == 0 && i > 0 && (i - 1) % 2 == 0)
        ring.release(i - 1, n_stages, lane, issue);
      if (group_end && kk == kSteps - 1) {
        // the group's products are complete: fold its scales
#pragma unroll
        for (int x = 0; x < BM / 2; ++x) {
          const bool odd = (x >> 1) & 1;  // fragment row g + 8: column n + 1
          acc[x] = acc[x] + (ga[x] * (odd ? sl.y : sl.x) +
                             gb[x] * (odd ? sh.y : sh.x));
        }
        ring.release(i, n_stages, lane, issue);
      }
      // the next step's fragments while this step runs
      if (kk + 1 < kSteps) {
        unpack_step(st, kk + 1, c, warp, g, t, fr[(kk + 1) & 1][0],
                    fr[(kk + 1) & 1][1]);
      } else if (i + 1 < n_stages) {
        ring.wait(i + 1);
        unpack_step(stages + ((i + 1) % kStages) * T::STAGE_BYTES, 0, c, warp,
                    g, t, fr[0][0], fr[0][1]);
      }
    }
  }

  // the scale was folded at each group's end
  store_split_k<BM>(acc, make_float2(1.f, 1.f), o, ws,
                    counters + blockIdx.y * gridDim.x + blockIdx.x, last_flag,
                    M, N, m0, n, t, sp, splits);
}

template <int BM>
int launch(const void* x, const void* packed, const void* scales, void* o,
           void* ws, void* counters, int M, int N, int K, int splits,
           cudaStream_t stream) {
  using T = W4Tile<BM>;
  static unsigned long long devices = 0;
  if (cudaError_t e =
          smem_limit_per_device(w4_mm_kernel<BM>, T::SMEM_BYTES, devices))
    return static_cast<int>(e);
  Maps maps;
  if (int e = map_2d(&maps.x, x, false, M, K, K, BM, 64)) return e;
  if (int e = map_2d_u8(&maps.packed, packed, K / 2, N, N, kStageRows, kBN))
    return e;
  const dim3 grid(cdiv(N, kBN), cdiv(M, BM), splits);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  w4_mm_kernel<BM><<<grid, kThreads, T::SMEM_BYTES, stream>>>(
      maps, static_cast<const float*>(scales), static_cast<uint16_t*>(o),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) bf16 with BM rows a CTA (8, 16, 32, 64 or LC_W4_PREFILL_M) and
// K cut into ``splits`` splits of whole groups (cdiv(K / 256, splits)
// groups each, none empty). splits > 1 needs ``ws`` (splits, M, N) f32 and
// ``counters`` (cdiv(M, BM) * cdiv(N, 128) ints, zero at launch, zero again
// after it); splits == 1 takes neither. Group 128; needs M > 0, K % 256 ==
// 0, N % 16 == 0 and 16-byte aligned operands. Returns cudaGetLastError()
// after the launch (0 = launched); launches on ``stream``, does not
// synchronise and allocates nothing.
extern "C" int lc_w4_matmul_bf16(const void* x, const void* packed,
                                 const void* scales, void* o, void* ws,
                                 void* counters, int M, int N, int K, int bm,
                                 int splits, void* stream) {
  const int groups = K / (2 * kGroup);
  if (M <= 0 || N <= 0 || K <= 0 || K % (2 * kGroup) || N % 16 ||
      splits < 1 || splits > groups ||
      cdiv(groups, cdiv(groups, splits)) != splits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8:
      return launch<8>(x, packed, scales, o, ws, counters, M, N, K, splits, st);
    case 16:
      return launch<16>(x, packed, scales, o, ws, counters, M, N, K, splits,
                        st);
    case 32:
      return launch<32>(x, packed, scales, o, ws, counters, M, N, K, splits,
                        st);
    case 64:
      return launch<64>(x, packed, scales, o, ws, counters, M, N, K, splits,
                        st);
#if LC_W4_PREFILL_M > 64
    case LC_W4_PREFILL_M:
      return launch<LC_W4_PREFILL_M>(x, packed, scales, o, ws, counters, M, N,
                                     K, splits, st);
#endif
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What this build was compiled with: info = {prefill rows, stages}. (The
// probes of LC_W4_PROBE, for bench/gemm_bench.py --w4, compute nothing
// right: 1 runs the products on fixed fragments, 2 leaves them out, and
// ptxas then drops the unpack whose results go nowhere: the feed alone.)
extern "C" int lc_w4_matmul_info(int* info) {
  info[0] = LC_W4_PREFILL_M;
  info[1] = kStages;
  return 0;
}
