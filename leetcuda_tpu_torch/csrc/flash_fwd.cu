// Flash-attention forward (FA-3 style: TMA + wgmma, f32 online softmax) for
// Hopper, bf16.
//
// Replaces: leetcuda_tpu/attention/flash.py make_flash_attention (_fa_body)
// and make_flash_attention_ragged (_fa_ragged_kernel). One kernel serves
// both: ``lengths`` is null for the plain entry point and a (B,) int32
// array of valid lengths for the ragged one, as _fa_body takes len_ref.
//
// Layouts are the JAX package's: q, o (B, H, Nq, D); k, v (B, Hkv, Nk, D),
// all contiguous; GQA reads kv head h / (H / Hkv). ``lse`` is null, or a
// (B, H, Nq) f32 array that receives each row's natural-log log-sum-exp of
// the scaled scores, m + log(max(l, 1e-30)), and -1e30 on ragged rows past
// the length (_fa_body with with_lse=True): the residual of the backward.
// ``window`` > 0 keeps the causal band rows - cols < window (flash.py:96-104)
// and ``softcap`` > 0 replaces each scaled score s by cap * tanh(s / cap)
// before the mask (flash.py:93-94); the lse is then that of the capped
// scores. 0 means neither.
//
// Bound on an H100 SXM: operations. Causal prefill at (1, 16, 2048, 128)
// does 17.2 GFLOP of Q.K^T and P.V and moves 34 MB: 17 us at the 989
// TFLOP/s bf16 tensor-core peak against 10 us of memory at 3.35 TB/s.
//
// Design (the Hopper datapath of hopper.cuh, as flash_bwd.cu's dQ kernel):
// * A CTA is two consumer warpgroups (256 threads) and owns 128 q rows of
//   one (b, h), 64 a warpgroup. Q is read once by TMA; K and V stream in
//   tiles of kKeys keys through a ring of stages (hopper.cuh ``Ring``: the
//   warp whose release completes a stage loads it again; no producer warp,
//   which would make a block of 9 warps and cap every thread at 168
//   registers). Operands are read through 3-D tensor maps over (D, N, B *
//   H) with the 128-byte swizzle, D as D / 64 boxes of 64: rows past N read
//   zeros, never the next head's rows.
// * Per tile a warpgroup issues S = Q K^T as SS wgmma (B K-major), waits,
//   runs the online softmax on S in f32 registers in the log2 domain (the
//   exp one ex2.approx.ftz, the cap one tanh.approx.f32, as the backward),
//   rescales its output accumulator, rounds P to bf16 in registers (the
//   accumulator's layout is the A layout) and issues O += P V as RS wgmma
//   with V MN-major. The scale folds into the exp: P = 2^(x sl - m sl),
//   one FFMA and one MUFU op an element. With LC_FWD_OVERLAP the warpgroup
//   does not wait for P V: the next tile's S is issued behind it and one
//   wait retires both, so the tensor cores see the two products back to
//   back and the stage of a tile is released one tile later. (FA-3's
//   softmax beside its own P V, and its ping-pong of the two warpgroups by
//   named barriers, both measured no faster here: ptxas serialized the
//   wgmma of the first, and the second's turns tied at head dim 128 and
//   lost 3% at 256; PERF.md rows 1-2.)
// * The band: the key tiles a CTA walks are key_range (common.cuh) over its
//   live rows (rows below the length, ragged); a warpgroup skips a tile
//   outside its own range and masks only tiles on the band's or the
//   length's edge, so tiles above the diagonal, past lengths[b] and wholly
//   left of a window are never loaded and a windowed forward is O(N *
//   window). The heaviest causal q tiles are scheduled first (blockIdx.x
//   reversed). Tiles wholly past a length write zeros and lse -1e30.
// * Padding past a length: the key tile across lengths[b] holds whatever
//   the cache holds past it (garbage, NaN); masked scores give P = 0, but 0
//   times NaN is NaN, so the warpgroup zeroes those V rows in shared memory
//   before its P V.
// * One CTA owns its rows' output and lse: no atomics, the same bits on
//   every call.
// The tile sizes and stage counts are the plan below (fwd_plan;
// lc_flash_fwd_plan reports them); the macros override them for the A/B of
// bench/attn_bench.py --fwd, which also builds three probes that compute
// nothing right: LC_FWD_PROBE 1 leaves out the exp (P is the exponent), 2
// every product, 3 the products and the softmax (the feed alone).
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

#ifndef LC_FWD_KEYS
#define LC_FWD_KEYS 0  // head dims 64 and 128: keys a stage (0: plan)
#endif
#ifndef LC_FWD_STAGES
#define LC_FWD_STAGES 0  // head dims 64 and 128: stages (0: plan)
#endif
#ifndef LC_FWD_OVERLAP
#define LC_FWD_OVERLAP 1  // the next tile's S issued behind this tile's P V
#endif
#ifndef LC_FWD_PROBE
#define LC_FWD_PROBE 0  // bench probes, wrong results: 1 no exp, 2 no products
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// consumer warpgroups (64 q rows each), keys a stage, stages
struct FwdPlan {
  int cons, keys, stages;
};
constexpr FwdPlan fwd_plan(int D) {
  return D > 128 ? FwdPlan{2, 64, 2}
                 : FwdPlan{2, LC_FWD_KEYS ? LC_FWD_KEYS : 128,
                           LC_FWD_STAGES ? LC_FWD_STAGES : (D > 64 ? 2 : 3)};
}

template <int D>
struct FwdTile {
  static constexpr FwdPlan P = fwd_plan(D);
  static constexpr int kCons = P.cons, kKeys = P.keys, kStages = P.stages;
  static constexpr int kRows = 64 * kCons, kBoxes = D / 64;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_BYTES = kKeys * D * 2;  // K (and V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * kCons;
  // from a 1024-byte aligned base: Q, the stages, then 1 + 2 kStages
  // mbarriers and release counters
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + kStages * STAGE_BYTES + 8 * (1 + 2 * kStages);
  static_assert(kKeys % 16 == 0 && kKeys <= 256, "key tile");
  static_assert(!LC_FWD_OVERLAP || kStages >= 2,
                "a stage is released one tile later");
  static_assert(SMEM_BYTES <= 232448, "forward tiles exceed the shared memory");
};

struct Maps {
  CUtensorMap q, k, v;
};

// kLse: write the lse (a separate instantiation, so the inference kernel
// carries no trace of it). kCap: the softcap, likewise.
template <int D, bool kLse, bool kCap>
__global__ void __launch_bounds__(FwdTile<D>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ Maps maps,
                 const int* __restrict__ lengths, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Nq, int Nk,
                 float scale_log2, int causal, int window,
                 float scale_over_cap, float cap_log2) {
  using T = FwdTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* stages = sq + T::Q_BYTES;
  uint64_t* qfull =
      reinterpret_cast<uint64_t*>(stages + T::kStages * T::STAGE_BYTES);
  const Ring<T::kStages, 4 * T::kCons> ring{
      qfull + 1, reinterpret_cast<int*>(qfull + 1 + T::kStages)};

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kRows;  // heaviest first
  const int seq_len = lengths ? lengths[b] : Nk;
  const int kv_len = min(seq_len, Nk);
  // rows that attend: ragged rows at or past the length are written as
  // zeros, their lse -1e30 (flash.py:163-178)
  const int live = lengths ? min(Nq, seq_len) : Nq;
  uint16_t* ob = o + (size_t)bh * Nq * D;
  float* lseb = kLse ? lse + (size_t)bh * Nq : nullptr;

  if (q0 >= live) {  // the whole tile lies past the length: nothing to do
    for (int i = threadIdx.x; i < T::kRows * (D / 8); i += T::THREADS) {
      const int row = q0 + i / (D / 8), col = (i % (D / 8)) * 8;
      if (row < Nq)
        *reinterpret_cast<uint4*>(ob + (size_t)row * D + col) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    if (kLse && threadIdx.x < T::kRows && q0 + threadIdx.x < Nq)
      lseb[q0 + threadIdx.x] = kNegInf;
    return;
  }

  int lo, hi;  // the CTA's keys
  key_range(q0, q0 + T::kRows, live, kv_len, causal, window, lo, hi);
  const int kt_lo = lo / T::kKeys;
  const int n_tiles = hi > lo ? cdiv(hi, T::kKeys) - kt_lo : 0;
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i, int s, uint64_t* bar) {
    mbar_expect_tx(bar, T::STAGE_BYTES);
    uint8_t* st = stages + s * T::STAGE_BYTES;
    const int k0 = (kt_lo + i) * T::kKeys;
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(st + j * T::kKeys * 128, &maps.k, bar, 64 * j, k0, bkv);
      tma_load_3d(st + T::KV_BYTES + j * T::kKeys * 128, &maps.v, bar, 64 * j,
                  k0, bkv);
    }
  };
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
    mbar_expect_tx(qfull, T::Q_BYTES);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j)
      tma_load_3d(sq + j * T::kRows * 128, &maps.q, qfull, 64 * j, q0, bh);
    ring.start(n_tiles, issue);
  }

  // this warpgroup's rows [r0, r0 + 64) and keys [lo_w, hi_w); the thread's
  // rows r0 + 16 warp + g + 8 j
  const int r0 = q0 + 64 * c;
  int lo_w, hi_w;
  key_range(r0, r0 + 64, live, kv_len, causal, window, lo_w, hi_w);
  const int rw = r0 + warp * 16 + g;

  float acc[D / 2], s[T::kKeys / 2];
  zero(acc);
  zero(s);
  // the running max m (in the units of x below: the raw score, or with the
  // cap the capped score in the log2 domain) and the denominator l
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float sl = kCap ? 1.f : scale_log2;  // x * sl is in the log2 domain
  uint32_t pa[T::kKeys / 16][4] = {};
  const uint32_t qa = smem_u32(sq) + c * 64 * 128;
  auto issue_s = [&](uint32_t kb) {  // S = Q K^T, B K-major, box ks / 4
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t qo = (ks / 4) * T::kRows * 128 + (ks % 4) * 32;
      const uint32_t ko = (ks / 4) * T::kKeys * 128 + (ks % 4) * 32;
      if (LC_FWD_PROBE < 2)
        wgmma_ss_bf16<0>(s, kmajor(qa + qo), kmajor(kb + ko), ks > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int i) {  // O += P V, V as B MN-major, 16 keys a step
    const uint32_t vb =
        smem_u32(stages + (i % T::kStages) * T::STAGE_BYTES) + T::KV_BYTES;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::kKeys / 16; ++kk)
      if (LC_FWD_PROBE < 2)
        wgmma_rs_bf16<1>(acc, pa[kk],
                         mnmajor(vb + kk * 2048, T::kKeys * 128), 1);
    wgmma_commit();
  };
  // the online softmax of tile k0 on S in s: scale (kCap: capped first),
  // mask only on the band's and the length's edges, the new max, P in f32
  // in s, its row sums; returns alpha, the old max's weight, in ``alpha``
  // One pass of the scores: x (kCap: capped) into s and the row maxima,
  // masked (x = -1e30) only when kMask. Four partial maxima a row keep
  // the max chains short; the test of the edge is made once a tile (a
  // branch inside the unrolled loop cost a branch an element).
  auto scores = [&](int k0, auto mask_tag, float (&mx)[2]) {
    constexpr bool kMask = decltype(mask_tag)::value;
    float part[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = kNegInf;
#pragma unroll
    for (int n = 0; n < T::kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * n + 2 * j + e;
          float v = kCap ? cap_log2 * tanh_cap(s[x] * scale_over_cap) : s[x];
          if (kMask && !keep(rw + 8 * j, k0 + 8 * n + 2 * t + e, Nq, kv_len,
                             causal, window))
            v = kNegInf;
          s[x] = v;
          part[j][(2 * n + e) % 4] = fmaxf(part[j][(2 * n + e) % 4], v);
        }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      mx[j] = fmaxf(fmaxf(m[j], fmaxf(part[j][0], part[j][1])),
                    fmaxf(part[j][2], part[j][3]));
  };
  // P = 2^(x sl - m sl), one FFMA and one MUFU op an element (kMask:
  // masked entries 0), into s, and its row sums (two partial sums a row)
  auto probs = [&](auto mask_tag, const float (&msl)[2], float (&rs)[2]) {
    constexpr bool kMask = decltype(mask_tag)::value;
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int n = 0; n < T::kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 4 * n + 2 * j + e;
          const float y = fmaf(s[x], sl, -msl[j]);
          const float pv = kMask && s[x] == kNegInf ? 0.f
                           : LC_FWD_PROBE == 1      ? y
                                                    : ex2(y);
          part[j][e] += pv;
          s[x] = pv;
        }
    rs[0] = part[0][0] + part[0][1];
    rs[1] = part[1][0] + part[1][1];
  };
  // the online softmax of tile k0 on S in s: P in f32 in s, its row sums
  // in rs, the old max's weight in alpha; the mask only on the band's and
  // the length's edges
  auto softmax = [&](int k0, float (&alpha)[2], float (&rs)[2]) {
    const bool edge = k0 + T::kKeys > kv_len ||
                      (causal && k0 + T::kKeys - 1 > r0) ||
                      (window > 0 && r0 + 63 - k0 >= window);
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
      // (m - mx) first: m * sl - mx * sl contracts to an FMA whose
      // rounding error at the -1e30 sentinel is ~1e23, and 2^that is inf
      alpha[j] = ex2((m[j] - mx[j]) * sl);
      m[j] = mx[j];
    }
    if (edge) {
      probs(std::true_type{}, msl, rs);
    } else {
      probs(std::false_type{}, msl, rs);
    }
  };
  // after the previous P V: the accumulator rescaled, P into the A
  // fragments of the next P V (the accumulator's layout is the A layout)
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
    for (int n = 0; n < T::kKeys / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        pa[n / 2][2 * (n % 2) + j] =
            pack_bf16x2(s[4 * n + 2 * j], s[4 * n + 2 * j + 1]);
  };

  // With LC_FWD_OVERLAP a tile's P V is not waited for: the next tile's S
  // is issued behind it and one wait retires both (``pending``: the tile
  // whose P V may still run; its stage is released after that wait).
  int pending = -1;
  mbar_wait(qfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    ring.wait(i);
    const int k0 = (kt_lo + i) * T::kKeys;
    const bool mine = k0 < hi_w && k0 + T::kKeys > lo_w;
    uint8_t* st = stages + (i % T::kStages) * T::STAGE_BYTES;
    if (mine && lengths != nullptr && k0 + T::kKeys > kv_len && kv_len < Nk) {
      // V rows [kv_len, min(k0 + kKeys, Nk)) hold the cache's padding: zero
      // them before P V (rows past Nk are TMA's zeros already)
      const int z0 = max(kv_len - k0, 0), z1 = min(T::kKeys, Nk - k0);
      const int per_box = (z1 - z0) * 8;  // 16-byte chunks
      for (int x = tid; x < T::kBoxes * per_box; x += 128) {
        const int j = x / per_box, r = z0 + (x % per_box) / 8;
        *reinterpret_cast<uint4*>(st + T::KV_BYTES + j * T::kKeys * 128 +
                                  r * 128 + (x % 8) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      fence_proxy_async_shared();
      named_sync(1 + c, 128);
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
    if (LC_FWD_PROBE != 3) {
      softmax(k0, alpha, rs);
      fold(alpha, rs);
    }
    issue_pv(i);
    if (LC_FWD_OVERLAP) {
      pending = i;
    } else {
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(pa);
      ring.release(i, n_tiles, lane, issue);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  fence_frag(pa);
  if (pending >= 0) ring.release(pending, n_tiles, lane, issue);

  // out = acc / max(l, 1e-30); ragged rows past the length are zeros. The
  // lse leaves the log2 domain: ln2 * (m sl + log2(max(l, 1e-30))).
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = rw + 8 * j;
    if (row >= Nq) continue;
    const bool dead = row >= live;  // selected, not multiplied: no NaN
    const float den = fmaxf(l[j], 1e-30f), inv = 1.f / den;
    // a row that keeps no key (l = 0) has the plain version's lse, -1e30
    if (kLse && t == 0)
      lseb[row] = dead || l[j] == 0.f
                      ? kNegInf
                      : 0.6931471805599453f * (m[j] * sl + log2f(den));
    uint16_t* orow = ob + (size_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          dead ? 0u
               : pack_bf16x2(acc[4 * n + 2 * j] * inv,
                             acc[4 * n + 2 * j + 1] * inv);
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* lse, int B, int H, int Hkv, int Nq, int Nk,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using T = FwdTile<D>;
  constexpr float kLog2e = 1.4426950408889634f;
  const bool cap = softcap > 0.f;
  auto kern = cap ? flash_fwd_kernel<D, kLse, true>
                  : flash_fwd_kernel<D, kLse, false>;
  static unsigned long long attr_devices[2] = {0, 0};  // per instantiation
  if (cudaError_t e =
          smem_limit_per_device(kern, T::SMEM_BYTES, attr_devices[cap]))
    return static_cast<int>(e);
  Maps maps;
  int err = map_3d(&maps.q, q, false, B * H, Nq, D, T::kRows, 64);
  if (!err) err = map_3d(&maps.k, k, false, B * Hkv, Nk, D, T::kKeys, 64);
  if (!err) err = map_3d(&maps.v, v, false, B * Hkv, Nk, D, T::kKeys, 64);
  if (err) return err;
  const dim3 grid(cdiv(Nq, T::kRows), B * H);
  kern<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      maps, static_cast<const int*>(lengths), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), H, Hkv, Nq, Nk, scale * kLog2e,
      causal || window > 0, window, cap ? scale / softcap : 0.f,
      softcap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* lengths,
             void* o, void* lse, int B, int H, int Hkv, int Nq, int Nk,
             float scale, int causal, int window, float softcap,
             cudaStream_t s) {
  return lse != nullptr
             ? launch<D, true>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                               scale, causal, window, softcap, s)
             : launch<D, false>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                                scale, causal, window, softcap, s);
}

template <int D>
void plan_info(int* info) {
  using T = FwdTile<D>;
  const int vals[4] = {T::kRows, T::kKeys, T::kStages, T::SMEM_BYTES};
  for (int i = 0; i < 4; ++i) info[i] = vals[i];
}

}  // namespace

// Head dims 64, 128 and 256; every operand 16-byte aligned. Returns
// cudaGetLastError() after the launch (0 = launched). ``lengths`` may be
// null (plain flash attention), and so may ``lse`` (no LSE output).
// ``window`` > 0 implies causal; ``window`` <= 0 and ``softcap`` <= 0 mean
// none. Launches on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o, void* lse,
                                 int B, int H, int Hkv, int Nq, int Nk, int D,
                                 float scale, int causal, int window,
                                 float softcap, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || B * H > 65535 || Nq <= 0 ||
      Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk, scale,
                          causal, window, softcap, s);
    case 128:
      return launch_d<128>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk, scale,
                           causal, window, softcap, s);
    case 256:
      return launch_d<256>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk, scale,
                           causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan this build launches at head dim D: info = {q rows, keys a
// stage, stages, shared bytes}. Returns a CUDA error code.
extern "C" int lc_flash_fwd_plan(int D, int* info) {
  switch (D) {
    case 64:
      plan_info<64>(info);
      return 0;
    case 128:
      plan_info<128>(info);
      return 0;
    case 256:
      plan_info<256>(info);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
