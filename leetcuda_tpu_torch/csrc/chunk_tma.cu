// Chunk attention for Hopper, route B: TMA + wgmma tiles (FA-3 style, f32
// online softmax), the route of chunked prefill and prefix-cached admission
// (many rows per KV head). Route A, split-KV for verify, and the contract of
// both are csrc/chunk_attn.cu's; attention/chunk.py ``chunk_plan`` picks
// the route from shapes alone.
//
// Replaces: leetcuda_tpu/attention/chunk.py make_chunk_attention and
// make_paged_chunk_attention (_chunk_kernel) where chunk_plan names route B.
//
// Bound on an H100 SXM: operations. Gemma-2-27B's chunk of T=512 (32 heads
// of 128, 16 KV heads, bases 3700 / 5000, window 4096) does 67.5 GFLOP of
// Q.K^T and P.V: 68 us at the 989 TFLOP/s bf16 tensor-core peak.
//
// Design (csrc/flash_fwd.cu's datapath on hopper.cuh):
// * A CTA is two consumer warpgroups (256 threads) and owns 128 of the G * T
//   query rows of one (sequence, KV head), 64 a warpgroup: row r = g * T +
//   t, so at G = 2, T = 512 a CTA's rows lie in one g. Q is read once by
//   TMA through a 3-D map over (D, G * T, B * Hkv); rows past G * T read
//   zeros. K and V stream in tiles of kKeys keys through a ring of stages
//   (hopper.cuh ``Ring``: the warp whose release completes a stage loads it
//   again). Per tile a warpgroup issues S = Q K^T as SS wgmma, runs the
//   online softmax in f32 registers in the log2 domain (the exp ex2.approx,
//   the cap tanh.approx), rounds P to bf16 in registers and issues O += P V
//   as RS wgmma; a bf16 cache issues the next tile's S behind P V.
// * The band. Rows with chunk positions t_lo..t_hi walk the key tiles from
//   base + t_lo + 1 - window (0 without a window) to base + t_hi + 1, capped
//   at the capacity (common.cuh key_range with the base offset); tiles
//   outside are never loaded. A warpgroup masks only a tile that crosses
//   the smallest limit of its rows or the largest window floor.
// * Feeds. A contiguous bf16 cache: a 3-D map over (D, S, B * Hkv), as the
//   flash forward. Paged bf16 pools: a map over (D, page, N * Hkv); the
//   issuing thread reads each box's page from the table. When page < kKeys
//   a stage is kKeys / page boxes of one page each; when page >= kKeys and
//   page % kKeys == 0 it is one box inside a page. Every box then starts on
//   a 1024-byte boundary, the 128-byte swizzle's 8-row atom, which needs
//   page % 8 == 0; any other page size takes route A (chunk_plan). Boxes of
//   pages at or past ceil(end / page) are not issued: the table's filler is
//   never read. Quantized caches (int8 / e4m3): the raw bytes of a stage
//   come by 1-D bulk copies (a run of rows of one page or of the cache, the
//   rows below end only), the f32 scales by plain loads issued before the
//   work they wait on; both warpgroups dequantize a stage, exactly, into
//   bf16 tiles in the swizzled layout the descriptors read and release it
//   at once (the next bulk copies start), then run S and P V on the bf16
//   tiles. K has two tiles, so that the next tile's K is dequantized while
//   this tile's P V runs; V has one, written once both warpgroups retired
//   their P V (a bench A/B: PERF.md rows 6-7).
//   The rounding points are the plain version's: the scores fold in
//   k_scale, the denominator sums p, P V takes p * v_scale rounded to bf16.
// * Padding past end = min(base + T, S) (a torch.empty tail, a page's tail,
//   the null page 0, table filler, the e4m3 NaN bytes 0x7F / 0xFF): the
//   scores are masked (replaced, so NaN cannot pass), and the V rows are
//   zeroed in shared memory before P V (0 x NaN is NaN), as flash_fwd.cu
//   does past a length; a quantized stage writes zeros there.
// * One CTA owns its rows' output and lse: no atomics, the same bits on
//   every call. A row that attends no key gets lse -1e30 and zeros.
// The tiles and stages are ``tma_plan`` (lc_chunk_tma_plan reports them);
// the macros LC_CHUNK_KEYS and LC_CHUNK_STAGES override them at head dims
// 64 and 128 for the A/B of bench/attn_bench.py --chunk.
#include <type_traits>

#include "cache_policy.cuh"
#include "common.cuh"
#include "hopper.cuh"

#ifndef LC_CHUNK_KEYS
#define LC_CHUNK_KEYS 0  // head dims 64 and 128: keys a stage (0: plan)
#endif
#ifndef LC_CHUNK_STAGES
#define LC_CHUNK_STAGES 0  // head dims 64 and 128: stages (0: plan)
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// keys a stage and stages by head dim (the flash forward's plan)
struct TmaPlan {
  int keys, stages;
};
constexpr TmaPlan tma_plan(int D) {
  return D > 128 ? TmaPlan{64, 2}
                 : TmaPlan{LC_CHUNK_KEYS ? LC_CHUNK_KEYS : 128,
                           LC_CHUNK_STAGES ? LC_CHUNK_STAGES
                                           : (D > 64 ? 2 : 3)};
}

template <int D, bool kQuant>
struct Tile {
  static constexpr TmaPlan P = tma_plan(D);
  static constexpr int kKeys = P.keys, kStages = P.stages;
  static constexpr int kRows = 128, kBoxes = D / 64, THREADS = 256;
  static constexpr int Q_BYTES = kRows * D * 2;
  // K (and V) of a stage as stored: bf16 swizzled, or raw bytes
  static constexpr int KV_BYTES = kKeys * D * (kQuant ? 1 : 2);
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // quantized: the dequantized bf16 tiles (two of K, one of V) and their
  // scales
  static constexpr int BF_BYTES = kQuant ? kKeys * D * 2 : 0;
  static constexpr int SCALE_BYTES = kQuant ? 3 * kKeys * 4 : 0;
  // from a 1024-byte aligned base: Q, the bf16 tiles, the stages, the
  // scales, then 1 + 2 kStages mbarriers and release counters
  static constexpr int SMEM_BYTES = 1024 + Q_BYTES + 3 * BF_BYTES +
                                    kStages * STAGE_BYTES + SCALE_BYTES +
                                    8 * (1 + 2 * kStages);
  static_assert(kKeys % 16 == 0 && kKeys <= 256, "key tile");
  static_assert(kStages >= 2, "a stage is released one tile later");
  static_assert(SMEM_BYTES <= 232448, "chunk tiles exceed the shared memory");
};

struct Maps {
  CUtensorMap q, k, v;
};

// The chunk positions t_lo..t_hi of rows [r0, r1) (r1 > r0) of the G * T:
// one g's run of t, or every t where the rows cross into the next g.
__device__ __forceinline__ void t_span(int r0, int r1, int T, int& t_lo,
                                       int& t_hi) {
  if (r0 / T == (r1 - 1) / T) {
    t_lo = r0 % T;
    t_hi = (r1 - 1) % T;
  } else {
    t_lo = 0;
    t_hi = T - 1;
  }
}

// The keys [lo, hi) that rows [r0, r1) of R attend ((0, 0): none).
__device__ __forceinline__ void chunk_keys(int r0, int r1, int R, int T,
                                           int base, int S, int window,
                                           int& lo, int& hi) {
  r1 = min(r1, R);
  lo = hi = 0;
  if (r1 <= r0) return;
  int t_lo, t_hi;
  t_span(r0, r1, T, t_lo, t_hi);
  lo = window > 0 ? max(base + t_lo + 1 - window, 0) : 0;
  hi = min(base + t_hi + 1, S);
  if (hi <= lo) lo = hi = 0;
}

// The key tiles of ``keys`` that rows [r0, r1) walk: tiles [kt_lo, kt_lo +
// n) in order, the ``gap_n`` from tile ``gap_at`` on skipped. A run of rows
// across one g boundary whose positions t_a..T-1 and 0..t_b do not meet
// attends two bands; tiles wholly between them (a window shorter than the
// chunk) are never loaded.
__device__ __forceinline__ void chunk_tiles(int r0, int r1, int R, int T,
                                            int base, int S, int window,
                                            int keys, int& kt_lo, int& n,
                                            int& gap_at, int& gap_n) {
  int lo, hi;
  chunk_keys(r0, r1, R, T, base, S, window, lo, hi);
  kt_lo = lo / keys;
  n = hi > lo ? cdiv(hi, keys) - kt_lo : 0;
  gap_at = gap_n = 0;
  r1 = min(r1, R);
  if (n == 0 || window <= 0 || (r1 - 1) / T != r0 / T + 1) return;
  const int t_a = r0 % T, t_b = (r1 - 1) % T;
  const int g_hi = min(base + t_b + 1, S);           // the second run's end
  const int g_lo = max(base + t_a + 1 - window, 0);  // the first run's start
  const int a = cdiv(g_hi, keys), e = min(g_lo / keys, kt_lo + n);
  if (t_b + 1 < t_a && e > a) {
    gap_at = a;
    gap_n = e - a;
    n -= gap_n;
  }
}

// kCap: the softcap (a separate instantiation, so the uncapped kernel
// carries no tanh). C: the cache's element policy (cache_policy.cuh).
template <class C, int D, bool kCap>
__global__ void __launch_bounds__(256, 1)
chunk_tma_kernel(const __grid_constant__ Maps maps,
                 const typename C::T* __restrict__ kc,
                 const typename C::T* __restrict__ vc,
                 const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale,
                 const int* __restrict__ table,
                 const int* __restrict__ base_lengths,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int Hkv,
                 int R, int T, int S, int page, int window, float scale_log2,
                 float scale_over_cap, float cap_log2) {
  constexpr bool kQuant = C::kScaled;
  using Tl = Tile<D, kQuant>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* sbf = sq + Tl::Q_BYTES;  // quantized: bf16 K twice, then V
  uint8_t* vbuf = sbf + 2 * Tl::BF_BYTES;
  uint8_t* stages = sbf + 3 * Tl::BF_BYTES;
  // quantized: the K scales of the two K tiles, then the V tile's
  float* sks = reinterpret_cast<float*>(stages + Tl::kStages * Tl::STAGE_BYTES);
  float* svs = sks + 2 * Tl::kKeys;
  const float* ksc_tile = sks;  // the K scales of the tile in the scores
  uint64_t* qfull = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(sks) + Tl::SCALE_BYTES);
  const Ring<Tl::kStages, 8> ring{
      qfull + 1, reinterpret_cast<int*>(qfull + 1 + Tl::kStages)};

  const int bkv = blockIdx.y, b = bkv / Hkv, kvh = bkv % Hkv;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * Tl::kRows;  // heaviest first
  const int base = min(max(base_lengths[b], 0), S);
  const int end = min(base + T, S);  // positions at or past it: padding
  const int n_pages = page > 0 ? cdiv(end, page) : 0;  // pages looked up
  const int* tb = page > 0 ? table + (size_t)b * (S / page) : nullptr;
  uint16_t* ob = o + (size_t)bkv * R * D;
  float* lseb = lse != nullptr ? lse + (size_t)bkv * R : nullptr;

  int kt_lo, n_tiles, gap_at, gap_n;  // the CTA's key tiles
  chunk_tiles(q0, q0 + Tl::kRows, R, T, base, S, window, Tl::kKeys, kt_lo,
              n_tiles, gap_at, gap_n);
  // the first key of tile i of the walk
  auto tile_k0 = [&](int i) {
    const int kt = kt_lo + i;
    return (kt >= gap_at && gap_n > 0 ? kt + gap_n : kt) * Tl::kKeys;
  };
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  // key j's row among the (rows, D) rows of the cache or pool (j < end)
  auto cache_row = [&](int j) -> size_t {
    if (page > 0) {
      const int lp = j / page;
      return ((size_t)tb[lp] * Hkv + kvh) * page + (j - lp * page);
    }
    return (size_t)bkv * S + j;
  };
  auto issue = [&](int i, int s, uint64_t* bar) {
    uint8_t* st = stages + s * Tl::STAGE_BYTES;
    const int k0 = tile_k0(i);
    if constexpr (kQuant) {
      // runs of rows below end, one page (or the whole tile) each
      const int run = page > 0 && page < Tl::kKeys ? page : Tl::kKeys;
      uint32_t bytes = 0;
      for (int r = 0; r < Tl::kKeys; r += run) {
        const int n = min(run, end - (k0 + r));
        if (n > 0) bytes += 2u * n * D;
      }
      mbar_expect_tx(bar, bytes);
      for (int r = 0; r < Tl::kKeys; r += run) {
        const int n = min(run, end - (k0 + r));
        if (n <= 0) break;
        const size_t at = cache_row(k0 + r) * D;
        bulk_load(st + r * D, kc + at, n * D, bar);
        bulk_load(st + Tl::KV_BYTES + r * D, vc + at, n * D, bar);
      }
    } else if (page > 0) {
      // boxes of min(page, kKeys) rows, each inside one page; none of a
      // page at or past n_pages
      const int box = min(page, Tl::kKeys);
      uint32_t bytes = 0;
      for (int r = 0; r < Tl::kKeys; r += box)
        if ((k0 + r) / page < n_pages) bytes += 2u * Tl::kBoxes * box * 128;
      mbar_expect_tx(bar, bytes);
      for (int r = 0; r < Tl::kKeys; r += box) {
        const int lp = (k0 + r) / page;
        if (lp >= n_pages) break;
        const int z = tb[lp] * Hkv + kvh, y = (k0 + r) - lp * page;
#pragma unroll
        for (int j = 0; j < Tl::kBoxes; ++j) {
          tma_load_3d(st + j * Tl::kKeys * 128 + r * 128, &maps.k, bar,
                      64 * j, y, z);
          tma_load_3d(st + Tl::KV_BYTES + j * Tl::kKeys * 128 + r * 128,
                      &maps.v, bar, 64 * j, y, z);
        }
      }
    } else {
      mbar_expect_tx(bar, Tl::STAGE_BYTES);
#pragma unroll
      for (int j = 0; j < Tl::kBoxes; ++j) {
        tma_load_3d(st + j * Tl::kKeys * 128, &maps.k, bar, 64 * j, k0, bkv);
        tma_load_3d(st + Tl::KV_BYTES + j * Tl::kKeys * 128, &maps.v, bar,
                    64 * j, k0, bkv);
      }
    }
  };
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    if (!kQuant) {
      prefetch_map(&maps.k);
      prefetch_map(&maps.v);
    }
    mbar_expect_tx(qfull, Tl::Q_BYTES);
#pragma unroll
    for (int j = 0; j < Tl::kBoxes; ++j)
      tma_load_3d(sq + j * Tl::kRows * 128, &maps.q, qfull, 64 * j, q0, bkv);
    ring.start(n_tiles, issue);
  }

  // this warpgroup's rows [r0, r0 + 64) and keys [lo_w, hi_w); the thread's
  // rows rw + 8 j, each with its limit and window floor
  const int r0 = q0 + 64 * c;
  int lo_w, hi_w;
  chunk_keys(r0, r0 + 64, R, T, base, S, window, lo_w, hi_w);
  // a tile [k0, k0 + kKeys) needs no mask where it lies below every row's
  // limit and at or above every row's window floor
  int lim_min = 0, flo_max = 0;
  if (r0 < R) {
    int t_lo, t_hi;
    t_span(r0, min(r0 + 64, R), T, t_lo, t_hi);
    lim_min = min(base + t_lo + 1, S);
    flo_max = base + t_hi + 1 - window;
  }
  const int rw = r0 + warp * 16 + g;
  int lim[2], flo[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = rw + 8 * j, tr = row % T;
    lim[j] = row < R ? min(base + tr + 1, S) : 0;
    flo[j] = window > 0 ? base + tr + 1 - window : 0;
  }

  float acc[D / 2], s[Tl::kKeys / 2];
  zero(acc);
  zero(s);
  // the running max m (in the units of x below: the raw score, times the
  // key's scale when quantized, or with the cap the capped score in the
  // log2 domain) and the denominator l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl = kCap ? 1.f : scale_log2;  // x * sl is in the log2 domain
  uint32_t pa[Tl::kKeys / 16][4] = {};
  const uint32_t qa = smem_u32(sq) + c * 64 * 128;
  auto issue_s = [&](uint32_t kb) {  // S = Q K^T, B K-major, box ks / 4
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t qo = (ks / 4) * Tl::kRows * 128 + (ks % 4) * 32;
      const uint32_t ko = (ks / 4) * Tl::kKeys * 128 + (ks % 4) * 32;
      wgmma_ss_bf16<0>(s, kmajor(qa + qo), kmajor(kb + ko), ks > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](uint32_t vb) {  // O += P V, V MN-major, 16 keys a step
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Tl::kKeys / 16; ++kk)
      wgmma_rs_bf16<1>(acc, pa[kk], mnmajor(vb + kk * 2048, Tl::kKeys * 128),
                       1);
    wgmma_commit();
  };
  // One pass of the scores: x (quantized: times the key's scale; kCap:
  // capped) into s and the row maxima, masked (x = -1e30) only when kMask.
  auto scores = [&](int k0, auto mask_tag, float (&mx)[2]) {
    constexpr bool kMask = decltype(mask_tag)::value;
    float part[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = kNegInf;
#pragma unroll
    for (int n = 0; n < Tl::kKeys / 8; ++n) {
      float2 ksc = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        ksc = *reinterpret_cast<const float2*>(ksc_tile + 8 * n + 2 * t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * n + 2 * j + e;
          float v = s[x];
          if constexpr (kQuant) v *= e ? ksc.y : ksc.x;
          if constexpr (kCap) v = cap_log2 * tanh_cap(v * scale_over_cap);
          const int col = k0 + 8 * n + 2 * t + e;
          if (kMask && !(col < lim[j] && col >= flo[j])) v = kNegInf;
          s[x] = v;
          part[j][(2 * n + e) % 4] = fmaxf(part[j][(2 * n + e) % 4], v);
        }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mx[j] = fmaxf(fmaxf(m[j], fmaxf(part[j][0], part[j][1])),
                    fmaxf(part[j][2], part[j][3]));
  };
  // P = 2^(x sl - m sl) (kMask: masked entries 0) into s, its row sums
  auto probs = [&](auto mask_tag, const float (&msl)[2], float (&rs)[2]) {
    constexpr bool kMask = decltype(mask_tag)::value;
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < Tl::kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * n + 2 * j + e;
          const float pv =
              kMask && s[x] == kNegInf ? 0.f : ex2(fmaf(s[x], sl, -msl[j]));
          part[j][e] += pv;
          s[x] = pv;
        }
    rs[0] = part[0][0] + part[0][1];
    rs[1] = part[1][0] + part[1][1];
  };
  auto softmax = [&](int k0, float (&alpha)[2], float (&rs)[2]) {
    const bool edge = k0 + Tl::kKeys > lim_min ||
                      (window > 0 && k0 < flo_max);
    float mx[2], msl[2];
    if (edge) {
      scores(k0, std::true_type{}, mx);
    } else {
      scores(k0, std::false_type{}, mx);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      msl[j] = mx[j] * sl;
      // (m - mx) first, as flash_fwd.cu: no FMA at the -1e30 sentinel
      alpha[j] = ex2((m[j] - mx[j]) * sl);
      m[j] = mx[j];
    }
    if (edge) {
      probs(std::true_type{}, msl, rs);
    } else {
      probs(std::false_type{}, msl, rs);
    }
  };
  // after the previous P V: the accumulator rescaled, P (quantized: p *
  // v_scale) into the A fragments of the next P V
  auto fold = [&](const float (&alpha)[2], float (&rs)[2]) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 1);
      rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], 2);
      l[j] = alpha[j] * l[j] + rs[j];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[4 * n + x] *= alpha[x / 2];
#pragma unroll
    for (int n = 0; n < Tl::kKeys / 8; ++n) {
      float2 vsc = make_float2(1.f, 1.f);
      if constexpr (kQuant)
        vsc = *reinterpret_cast<const float2*>(svs + 8 * n + 2 * t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        pa[n / 2][2 * (n % 2) + j] = pack_bf16x2(
            kQuant ? s[4 * n + 2 * j] * vsc.x : s[4 * n + 2 * j],
            kQuant ? s[4 * n + 2 * j + 1] * vsc.y : s[4 * n + 2 * j + 1]);
    }
  };
  // quantized: K (``which`` 0) or V (1) of stage i's raw bytes into the
  // bf16 tile at ``dst``, swizzled as TMA would have written it (16-byte
  // chunk x of row r at x ^ (r % 8)), zeros at or past end; every thread of
  // the CTA takes part
  auto dequant = [&](int i, int which, uint8_t* dst) {
    const uint8_t* raw =
        stages + (i % Tl::kStages) * Tl::STAGE_BYTES + which * Tl::KV_BYTES;
    const int k0 = tile_k0(i);
    constexpr int VR = D / 16;  // 16-byte raw vectors a row
    for (int x = threadIdx.x; x < Tl::kKeys * VR; x += Tl::THREADS) {
      const int r = x / VR, c16 = (x % VR) * 16;  // row, first column
      uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
      if (k0 + r < end) {
        float f[16];
        C::vec(*reinterpret_cast<const uint4*>(raw + r * D + c16), f);
        w0 = make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                        pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
        w1 = make_uint4(pack_bf16x2(f[8], f[9]), pack_bf16x2(f[10], f[11]),
                        pack_bf16x2(f[12], f[13]),
                        pack_bf16x2(f[14], f[15]));
      }
      uint8_t* row = dst + (c16 / 64) * Tl::kKeys * 128 + r * 128;
      const int x0 = (c16 % 64) / 8;  // the first of the two 16-byte chunks
      *reinterpret_cast<uint4*>(row + ((x0 ^ (r & 7)) * 16)) = w0;
      *reinterpret_cast<uint4*>(row + (((x0 + 1) ^ (r & 7)) * 16)) = w1;
    }
  };
  // the K (0) or V (1) scale of key tile_k0(i) + threadIdx.x, 0 at or
  // past end
  auto scale_of = [&](int i, int which) {
    const int j = tile_k0(i) + threadIdx.x;
    return threadIdx.x < Tl::kKeys && j < end
               ? (which ? v_scale : k_scale)[cache_row(j)]
               : 0.f;
  };

  mbar_wait(qfull, 0);
  if constexpr (kQuant) {
    // Tile i's K in the bf16 K tile i % 2, its V in the V tile. While P V
    // of tile i runs, tile i + 1's K is dequantized into the other K tile
    // (its last reader, S of tile i - 1, retired before the barriers that
    // published tile i); once both warpgroups retired P V, its V follows.
    // A stage is released as soon as it is dequantized.
    auto publish = [&](int i) {  // V, the scales, the barrier, the release
      fence_proxy_async_shared();
      named_sync(1, Tl::THREADS);  // tile i written, its stage read
      ring.release(i, n_tiles, lane, issue);
    };
    if (n_tiles > 0) {
      ring.wait(0);
      const float k_s = scale_of(0, 0), v_s = scale_of(0, 1);
      dequant(0, 0, sbf);
      dequant(0, 1, vbuf);
      if (threadIdx.x < Tl::kKeys) {
        sks[threadIdx.x] = k_s;
        svs[threadIdx.x] = v_s;
      }
      publish(0);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int k0 = tile_k0(i);
      const bool mine = k0 < hi_w && k0 + Tl::kKeys > lo_w;
      ksc_tile = sks + (i % 2) * Tl::kKeys;
      if (mine) {
        issue_s(smem_u32(sbf + (i % 2) * Tl::BF_BYTES));
        wgmma_wait<0>();
        fence_acc(s);
        float alpha[2], rs[2];
        softmax(k0, alpha, rs);
        fold(alpha, rs);
        issue_pv(smem_u32(vbuf));
      }
      if (i + 1 < n_tiles) {
        ring.wait(i + 1);
        const float k_s = scale_of(i + 1, 0), v_s = scale_of(i + 1, 1);
        dequant(i + 1, 0, sbf + ((i + 1) % 2) * Tl::BF_BYTES);
        if (threadIdx.x < Tl::kKeys)
          sks[((i + 1) % 2) * Tl::kKeys + threadIdx.x] = k_s;
        wgmma_wait<0>();  // this warpgroup's P V of tile i
        fence_acc(acc);
        fence_frag(pa);
        named_sync(1, Tl::THREADS);  // both: the V tile is free
        dequant(i + 1, 1, vbuf);
        if (threadIdx.x < Tl::kKeys) svs[threadIdx.x] = v_s;
        publish(i + 1);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
  } else {
    // A tile's P V is not waited for: the next tile's S is issued behind
    // it and one wait retires both (``pending``: the tile whose P V may
    // still run; its stage is released after that wait).
    int pending = -1;
    for (int i = 0; i < n_tiles; ++i) {
      ring.wait(i);
      const int k0 = tile_k0(i);
      const bool mine = k0 < hi_w && k0 + Tl::kKeys > lo_w;
      uint8_t* st = stages + (i % Tl::kStages) * Tl::STAGE_BYTES;
      if (mine && k0 + Tl::kKeys > end) {
        // V rows [end, k0 + kKeys) hold padding or were not loaded: zero
        // them before P V
        const int z0 = max(end - k0, 0);
        const int per_box = (Tl::kKeys - z0) * 8;  // 16-byte chunks
        for (int x = tid; x < Tl::kBoxes * per_box; x += 128) {
          const int j = x / per_box, r = z0 + (x % per_box) / 8;
          *reinterpret_cast<uint4*>(st + Tl::KV_BYTES + j * Tl::kKeys * 128 +
                                    r * 128 + (x % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        fence_proxy_async_shared();
        named_sync(2 + c, 128);
      }
      if (mine) issue_s(smem_u32(st));
      wgmma_wait<0>();  // S (and the previous tile's P V)
      fence_acc(s);
      fence_acc(acc);
      fence_frag(pa);
      if (pending >= 0) {
        ring.release(pending, n_tiles, lane, issue);
        pending = -1;
      }
      if (!mine) {
        ring.release(i, n_tiles, lane, issue);
        continue;
      }
      float alpha[2], rs[2];
      softmax(k0, alpha, rs);
      fold(alpha, rs);
      issue_pv(smem_u32(st) + Tl::KV_BYTES);
      pending = i;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    fence_frag(pa);
    if (pending >= 0) ring.release(pending, n_tiles, lane, issue);
  }

  // out = acc / max(l, 1e-30); the lse leaves the log2 domain: ln2 * (m sl
  // + log2(max(l, 1e-30))), -1e30 for a row that kept no key
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = rw + 8 * j;
    if (row >= R) continue;
    const float den = fmaxf(l[j], 1e-30f), inv = 1.f / den;
    if (lseb != nullptr && t == 0)
      lseb[row] = l[j] == 0.f ? kNegInf
                              : 0.6931471805599453f * (m[j] * sl + log2f(den));
    uint16_t* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16x2(acc[4 * n + 2 * j] * inv, acc[4 * n + 2 * j + 1] * inv);
  }
}

template <class C, int D, bool kCap>
int launch_k(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* base, void* o,
             void* lse, int B, int H, int Hkv, int T, int S, int page,
             int pool_pages, float scale, int window, float softcap,
             cudaStream_t stream) {
  using Tl = Tile<D, C::kScaled>;
  constexpr float kLog2e = 1.4426950408889634f;
  auto kern = chunk_tma_kernel<C, D, kCap>;
  static unsigned long long attr_devices = 0;
  if (cudaError_t e =
          smem_limit_per_device(kern, Tl::SMEM_BYTES, attr_devices))
    return static_cast<int>(e);
  const int R = H / Hkv * T;
  Maps maps{};
  int err = map_3d(&maps.q, q, false, B * Hkv, R, D, Tl::kRows, 64);
  if (!err && !C::kScaled) {
    if (page > 0) {
      const int box = page < Tl::kKeys ? page : Tl::kKeys;
      err = map_3d(&maps.k, k, false, pool_pages * Hkv, page, D, box, 64);
      if (!err) err = map_3d(&maps.v, v, false, pool_pages * Hkv, page, D, box, 64);
    } else {
      err = map_3d(&maps.k, k, false, B * Hkv, S, D, Tl::kKeys, 64);
      if (!err) err = map_3d(&maps.v, v, false, B * Hkv, S, D, Tl::kKeys, 64);
    }
  }
  if (err) return err;
  const dim3 grid(cdiv(R, Tl::kRows), B * Hkv);
  kern<<<grid, Tl::THREADS, Tl::SMEM_BYTES, stream>>>(
      maps, static_cast<const typename C::T*>(k),
      static_cast<const typename C::T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(base), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), Hkv, R, T, S, page, window, scale * kLog2e,
      kCap ? scale / softcap : 0.f, softcap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <class C, int D>
int by_cap(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* base, void* o,
           void* lse, int B, int H, int Hkv, int T, int S, int page,
           int pool_pages, float scale, int window, float softcap,
           cudaStream_t s) {
  return softcap > 0.f
             ? launch_k<C, D, true>(q, k, v, ks, vs, table, base, o, lse, B,
                                    H, Hkv, T, S, page, pool_pages, scale,
                                    window, softcap, s)
             : launch_k<C, D, false>(q, k, v, ks, vs, table, base, o, lse, B,
                                     H, Hkv, T, S, page, pool_pages, scale,
                                     window, softcap, s);
}

template <class C>
int by_dim(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* base, void* o,
           void* lse, int B, int H, int Hkv, int T, int S, int page,
           int pool_pages, int D, float scale, int window, float softcap,
           cudaStream_t s) {
  switch (D) {
    case 64:
      return by_cap<C, 64>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv,
                           T, S, page, pool_pages, scale, window, softcap, s);
    case 128:
      return by_cap<C, 128>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv,
                            T, S, page, pool_pages, scale, window, softcap, s);
    case 256:
      return by_cap<C, 256>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv,
                            T, S, page, pool_pages, scale, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
void plan_info(int* info) {
  using Tl = Tile<D, false>;
  using Tq = Tile<D, true>;
  const int vals[5] = {Tl::kRows, Tl::kKeys, Tl::kStages, Tl::SMEM_BYTES,
                       Tq::SMEM_BYTES};
  for (int i = 0; i < 5; ++i) info[i] = vals[i];
}

}  // namespace

// Route B; returns cudaGetLastError() after the launch (0 = launched).
// ``cache``: 0 bf16, 1 int8, 2 e4m3 (with f32 k_scale / v_scale). ``page``
// = 0: contiguous caches (B, Hkv, S, D); ``page`` > 0: pools (pool_pages, Hkv,
// page, D), ``table`` (B, S / page) int32, S = P_max * page, and page % 8 ==
// 0 with page % keys == 0 or keys % page == 0 (``lc_chunk_tma_plan``'s
// keys). q and o bf16 (B, H, T, D), every operand 16-byte aligned; head
// dims 64, 128 and 256; any group and T >= 1. ``window`` <= 0 and
// ``softcap`` <= 0 mean none; ``lse`` is null or (B, H, T) f32. Launches on
// ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_chunk_tma(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* table, const void* base_lengths,
                            void* o, void* lse, int B, int H, int Hkv, int T,
                            int S, int page, int pool_pages, int D, int cache,
                            float scale, int window, float softcap,
                            void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || (long long)B * Hkv > 65535 ||
      T <= 0 || S <= 0 || page < 0 || (page > 0 && (S % page != 0 ||
                                                     page % 8 != 0 ||
                                                     pool_pages <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (page > 0) {  // the paged feed's boxes: one page, or inside one page
    const int keys = tma_plan(D).keys;
    if (page % keys != 0 && keys % page != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache) {
    case 0:
      return by_dim<CacheBf16>(q, k, v, k_scale, v_scale, table, base_lengths,
                               o, lse, B, H, Hkv, T, S, page, pool_pages, D,
                               scale, window, softcap, s);
    case 1:
      return by_dim<CacheInt8>(q, k, v, k_scale, v_scale, table, base_lengths,
                               o, lse, B, H, Hkv, T, S, page, pool_pages, D,
                               scale, window, softcap, s);
    case 2:
      return by_dim<CacheE4m3>(q, k, v, k_scale, v_scale, table, base_lengths,
                               o, lse, B, H, Hkv, T, S, page, pool_pages, D,
                               scale, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Route B's plan at head dim D as this build has it: info = {q rows a CTA,
// keys a stage, stages, shared bytes (bf16 cache), shared bytes (quantized
// cache)}. Returns a CUDA error code.
extern "C" int lc_chunk_tma_plan(int D, int* info) {
  switch (D) {
    case 64: plan_info<64>(info); return 0;
    case 128: plan_info<128>(info); return 0;
    case 256: plan_info<256>(info); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
