// Flash-attention backward (FA-2) for Hopper, bf16: the dQ and dK/dV kernels,
// fed by TMA and computed by wgmma.
//
// Replaces: leetcuda_tpu/attention/flash_bwd.py _bwd, its two pallas_calls:
// _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK, dV), and the jnp op that
// forms delta = rowsum(dO * O) - dlse outside them (flash_bwd.py:176-179):
// the dQ kernel computes delta for its q tile and writes it for the dK/dV
// launch. Both recompute P = exp(C - lse) from the forward's saved
// log-sum-exp (no N x N residual), C the scaled score:
//   dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dV = P^T dO,  dK = scale * dS^T Q.
// With ``softcap`` > 0 the forward capped each scaled score, C = cap *
// tanh(s * scale / cap), so P is recomputed from C and dS is multiplied by
// 1 - (C / cap)^2 = 1 - tanh^2 (flash_bwd.py:56-57, 72-73); masked entries
// have P = 0. ``window`` > 0 keeps the band rows - cols < window (which
// implies causal). P and dS are rounded to bf16 before the second products,
// as the TPU kernel casts them.
//
// Layouts are the forward's: q, o, do, dq (B, H, Nq, D); k, v, dk, dv
// (B, Hkv, Nk, D), all contiguous bf16; lse, dlse, delta (B, H, Nq) f32.
// GQA: q head h reads kv head h / (H / Hkv); dK and dV sum each kv head's
// group of q heads in f32 inside the kernel (JAX repeats k / v and sums the
// group afterwards): one CTA owns a key tile's dK and dV, one a q tile's dQ,
// so there are no atomics and two calls give the same bits.
//
// Bound on an H100 SXM: operations. At (8, 16, 2048, 128) causal the whole
// backward needs five N x N x D products (S, dP, dQ, dK, dV), each 2 * B *
// H * N^2 * D / 2 FLOPs: 0.348 ms at the 989 TFLOP/s bf16 peak, against
// ~0.06 ms of memory at 3.35 TB/s. The two-kernel split does seven (S and
// dP in both kernels), so it reaches at most 5/7 of that bound.
//
// Design (the Hopper datapath of hopper.cuh):
// * Operands are read by TMA through 3-D tensor maps over (D, N, B * H)
//   with the 128-byte swizzle, a tile of D columns as D / 64 boxes of 64:
//   rows past N read zeros, never the next head's rows. A CTA is two
//   consumer warpgroups (256 threads) that issue every product as wgmma;
//   tiles stream through a ring of stages (``Ring``), each behind a "full"
//   mbarrier that counts the bytes; the warp whose release completes a
//   stage issues its next load at once. No producer warp: a block of 9
//   warps puts 3 on one of the SM's four register partitions and caps every
//   thread at 168 registers (a producer warpgroup with setmaxnreg leaves
//   dK/dV at head dim 128 spilling 812 bytes a thread); 8 warps leave 255.
// * dQ: a CTA owns DqTile::kRows = 64 x kCons q rows of one (b, h); Q and
//   dO stay resident, K and V stream in tiles of kKeys keys. Per tile a
//   warpgroup issues S = Q K^T, then dP = dO V^T (both operands in shared
//   memory, B K-major), forms P in registers while dP runs, then dS, and
//   issues dQ += dS K with dS as the A operand in registers (the
//   accumulator's layout is the A layout) and K MN-major. Before the walk
//   the consumers read O and dO for their rows from global memory and form
//   delta = rowsum(dO * O) - dlse in f32; they keep it and write it, with
//   lse * log2(e), to ``rows``, padded with zeros to 64 rows, for the
//   dK/dV launch's bulk copies.
// * dK/dV (head dims 64 and 128): a CTA owns DkvTile::kKeys = 64 x kCons
//   keys of one (b, kv head); K and V stay resident, and the ring streams
//   q tiles of kRowsQ rows (Q and dO by TMA, their lse2 and delta by 1-D
//   bulk copies from ``rows``) of every q head of the group. Per tile:
//   S^T = K Q^T, then dP^T = V dO^T (SS, B K-major); P^T is formed while
//   dP^T runs, dV += P^T dO issued, then dS^T formed and dK += dS^T Q
//   issued (RS, B MN-major).
// * dK/dV at head dim 256: two accumulators of 64 keys x 256 are 256 f32
//   registers a thread, past the 255 a thread may hold. The split-D kernel
//   lets two consumer warpgroups share 64 keys, each owning half of D for
//   both dK and dV (128 registers): warpgroup 0 computes S^T and
//   warpgroup 1 dP^T; warpgroup 0 writes P^T (bf16, in the swizzled
//   K-major layout a descriptor reads) and P^T times the cap's factor
//   (f32, in thread order: the two accumulators have the same layout) to
//   shared memory, warpgroup 1 forms dS^T from it and writes it as bf16,
//   named barriers order the two, and both issue dV += P^T dO and dK +=
//   dS^T Q for their half from shared memory: four products a tile pair.
//   (Two launches of the joint kernel, one for dV and one for dK, S^T
//   again, took 1.75x as long: PERF.md rows 8-9.)
// * The band: the tiles a CTA walks are the range of key_range (dQ) or
//   row_range (dK/dV) over its rows or keys (attention/flash_bwd.py
//   ``band_tiles`` mirrors both); a consumer warpgroup skips a tile outside
//   its own range, and masks only tiles on the band's or the tensors'
//   edges. The keep mask tests key < Nk and row < Nq: TMA's zero rows give
//   S = 0, not -1e30. dQ walks its q tiles heaviest first (blockIdx.x
//   reversed), dK/dV its key tiles in order (the first are heaviest).
// * P is one ex2.approx.ftz and the cap one tanh.approx.f32 (tanhf took
//   the cap-50 backward from 1.72 to 2.23 ms; the approximation holds every
//   cap check and its controls still fail: PERF.md rows 8-9).
// The tile sizes and stage counts are the plan below (dq_plan, dkv_plan;
// lc_flash_bwd_plan reports them); the macros override them for the A/B of
// bench/attn_bench.py --bwd, which also builds three probes that compute
// nothing right: LC_BWD_PROBE 1 leaves out the exp and the cap's tanh, 2
// every product, 3 the first two of a tile (S and dP, or S^T and dP^T).
// (Leaving out only the others lets ptxas drop the first ones, whose
// results then go nowhere.)
#include "common.cuh"
#include "hopper.cuh"

#ifndef LC_BWD_STAGES
#define LC_BWD_STAGES 0  // head dims 64 and 128: the ring's stages (0: plan)
#endif
#ifndef LC_BWD_DQ_KEYS
#define LC_BWD_DQ_KEYS 128  // head dims 64 and 128: dQ's key tile
#endif
#ifndef LC_BWD_DKV_ROWS
#define LC_BWD_DKV_ROWS 0  // head dims 64 and 128: dK/dV's q tile (0: plan)
#endif
#ifndef LC_BWD_D256_DQ_CONS
#define LC_BWD_D256_DQ_CONS 1  // head dim 256: dQ's consumer warpgroups
#endif
#ifndef LC_BWD_PROBE
#define LC_BWD_PROBE 0
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------------ plan

// dQ: consumer warpgroups (64 q rows each), keys a stage, stages.
struct DqPlan {
  int cons, keys, stages;
};
constexpr DqPlan dq_plan(int D) {
  return D > 128 ? DqPlan{LC_BWD_D256_DQ_CONS, 64 / LC_BWD_D256_DQ_CONS, 2}
                 : DqPlan{2, LC_BWD_DQ_KEYS,
                          LC_BWD_STAGES ? LC_BWD_STAGES : (D > 64 ? 2 : 3)};
}
// dK/dV: consumer warpgroups (64 keys each; at head dim 256 the split
// kernel's two, sharing 64, its tiles fixed by its 64 x 64 exchange), q
// rows a stage, stages.
struct DkvPlan {
  int cons, rows, stages;
  bool split;
};
constexpr DkvPlan dkv_plan(int D) {
  return D > 128 ? DkvPlan{2, 64, 2, true}
                 : DkvPlan{2, LC_BWD_DKV_ROWS ? LC_BWD_DKV_ROWS : 64,
                           LC_BWD_STAGES ? LC_BWD_STAGES : (D > 64 ? 2 : 3),
                           false};
}

// q rows of the rows buffer a (b, h) holds: lse in the log2 domain, then
// delta, each padded with zeros to a multiple of 64
__host__ __device__ constexpr int rows_pad(int Nq) { return cdiv(Nq, 64) * 64; }

template <int D>
struct DqTile {
  static constexpr DqPlan P = dq_plan(D);
  static constexpr int kCons = P.cons, kKeys = P.keys, kStages = P.stages;
  static constexpr int kRows = 64 * kCons, kBoxes = D / 64;
  static constexpr int Q_BYTES = kRows * D * 2;  // Q (and dO), resident
  static constexpr int KV_BYTES = kKeys * D * 2;  // K (and V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int THREADS = 128 * kCons;
  // from a 1024-byte aligned base: Q, dO, the stages, lse and delta of the
  // rows, then 1 + 2 kStages mbarriers
  static constexpr int SMEM_BYTES = 1024 + 2 * Q_BYTES +
                                    kStages * STAGE_BYTES + kRows * 8 +
                                    8 * (1 + 2 * kStages);
  static_assert(kKeys % 16 == 0 && kKeys <= 256, "key tile");
  static_assert(SMEM_BYTES <= 232448, "dQ tiles exceed the shared memory");
};

template <int D>
struct DkvTile {
  static constexpr DkvPlan P = dkv_plan(D);
  static constexpr bool kSplit = P.split;
  static constexpr int kCons = P.cons, kRowsQ = P.rows, kStages = P.stages;
  static constexpr int kKeys = kSplit ? 64 : 64 * kCons, kBoxes = D / 64;
  static constexpr int KV_BYTES = kKeys * D * 2;  // K (and V), resident
  static constexpr int Q_BYTES = kRowsQ * D * 2;  // Q (and dO) of a stage
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;  // a multiple of 1024
  static constexpr int ROW_BYTES = kRowsQ * 4;     // lse2 (and delta)
  static constexpr int LOAD_BYTES = STAGE_BYTES + 2 * ROW_BYTES;
  // the split kernel's exchange: P^T and dS^T (bf16, 64 x kRowsQ) and P^T
  // times the cap's factor (f32, in thread order)
  static constexpr int XCH_BYTES = kSplit ? 64 * kRowsQ * 8 : 0;
  static constexpr int THREADS = 128 * kCons;
  // from a 1024-byte aligned base: K, V, the stages, the exchange, lse2
  // and delta of each stage's rows, then 1 + 2 kStages mbarriers
  static constexpr int SMEM_BYTES = 1024 + 2 * KV_BYTES +
                                    kStages * (STAGE_BYTES + 2 * ROW_BYTES) +
                                    XCH_BYTES + 8 * (1 + 2 * kStages);
  static_assert(kRowsQ % 16 == 0 && kRowsQ <= 256, "q tile");
  static_assert(SMEM_BYTES <= 232448, "dK/dV tiles exceed the shared memory");
};

// ------------------------------------------------------------ elementwise

// The scalars of P and dS: scale * log2(e), scale / cap, cap * log2(e).
struct Consts {
  float scale_log2, scale_over_cap, cap_log2;
};

// P (in the log2 domain: lse2 = lse * log2(e)) of one score and, through
// ``capf``, the cap's factor 1 - tanh^2 (1 without a cap).
template <bool kCap>
__device__ __forceinline__ float prob(float s, float lse2, const Consts& k,
                                      float& capf) {
#if LC_BWD_PROBE == 1
  capf = 1.f;
  return s * k.scale_log2 - lse2;
#else
  if constexpr (kCap) {
    const float th = tanh_cap(s * k.scale_over_cap);
    capf = 1.f - th * th;
    return ex2(th * k.cap_log2 - lse2);
  } else {
    capf = 1.f;
    return ex2(s * k.scale_log2 - lse2);
  }
#endif
}

__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += __uint_as_float(x[i] << 16) * __uint_as_float(y[i] << 16);
    s += __uint_as_float(x[i] & 0xffff0000u) *
         __uint_as_float(y[i] & 0xffff0000u);
  }
  return s;
}

struct Maps {
  CUtensorMap q, dout, k, v;
};

// ------------------------------------------------------------------- dQ

// ``rows`` (B * H, 2, rows_pad(Nq)) f32: written here, lse * log2(e) and
// delta = rowsum(dO * O) - dlse, zeros past Nq, for the dK/dV launch.
template <int D, bool kCap>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ Maps maps,
                    const uint16_t* __restrict__ out,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dlse,
                    float* __restrict__ rows, uint16_t* __restrict__ dq,
                    int H, int Hkv, int Nq, int Nk, float scale, int causal,
                    int window, float softcap) {
  using T = DqTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sdo = sq + T::Q_BYTES;
  uint8_t* stages = sdo + T::Q_BYTES;
  float* srow =  // lse2 then delta of the CTA's rows
      reinterpret_cast<float*>(stages + T::kStages * T::STAGE_BYTES);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(srow + 2 * T::kRows);
  const Ring<T::kStages, 4 * T::kCons> ring{
      qfull + 1, reinterpret_cast<int*>(qfull + 1 + T::kStages)};

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int bkv = b * Hkv + h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::kRows;  // heaviest first
  int lo, hi;
  key_range(q0, q0 + T::kRows, Nq, Nk, causal, window, lo, hi);
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
          tma_load_3d(st + j * T::kKeys * 128, &maps.k, bar, 64 * j, k0,
                      bkv);
          tma_load_3d(st + T::KV_BYTES + j * T::kKeys * 128, &maps.v, bar,
                      64 * j, k0, bkv);
        }
      };
  if (threadIdx.x == 0) {
    prefetch_map(&maps.q);
    prefetch_map(&maps.dout);
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
    mbar_expect_tx(qfull, 2 * T::Q_BYTES);
#pragma unroll
    for (int j = 0; j < T::kBoxes; ++j) {
      tma_load_3d(sq + j * T::kRows * 128, &maps.q, qfull, 64 * j, q0, bh);
      tma_load_3d(sdo + j * T::kRows * 128, &maps.dout, qfull, 64 * j, q0,
                  bh);
    }
    ring.start(n_tiles, issue);
  }

  // this warpgroup's q rows [r0, r0 + 64): delta = rowsum(dO * O) - dlse,
  // D / 8 lanes a row, 16-byte loads; lse2 and delta to shared memory and
  // to the rows buffer
  const int r0 = q0 + 64 * c;
  const size_t rows0 = static_cast<size_t>(bh) * Nq;
  const int npad = rows_pad(Nq);
  float* rl = rows + static_cast<size_t>(bh) * 2 * npad;
  {
    constexpr int L = D / 8, RP = 32 / L;
#pragma unroll
    for (int p = 0; p < 16 / RP; ++p) {
      const int lr = warp * 16 + p * RP + lane / L, row = r0 + lr;
      float sum = 0.f;
      if (row < Nq) {
        const size_t off = (rows0 + row) * D + (lane % L) * 8;
        sum = dot_bf16x8(*reinterpret_cast<const uint4*>(out + off),
                         *reinterpret_cast<const uint4*>(dout + off));
      }
#pragma unroll
      for (int m = L / 2; m > 0; m >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, m);
      if (lane % L == 0) {
        float l2 = 0.f, d = 0.f;
        if (row < Nq) {
          d = dlse != nullptr ? sum - dlse[rows0 + row] : sum;
          l2 = lse[rows0 + row] * kLog2e;
        }
        if (row < npad) {
          rl[row] = l2;
          rl[npad + row] = d;
        }
        srow[64 * c + lr] = l2;
        srow[T::kRows + 64 * c + lr] = d;
      }
    }
  }
  named_sync(1 + c, 128);
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int lr = 64 * c + warp * 16 + g + 8 * i;
    lse2[i] = srow[lr];
    dl[i] = srow[T::kRows + lr];
  }
  const Consts kc{scale * kLog2e, kCap ? scale / softcap : 0.f,
                  softcap * kLog2e};
  int lo_w, hi_w;  // this warpgroup's keys
  key_range(r0, r0 + 64, Nq, Nk, causal, window, lo_w, hi_w);

  float acc[D / 2], s[T::kKeys / 2], dp[T::kKeys / 2];
  zero(acc);
  zero(s);
  zero(dp);
  uint32_t dsa[T::kKeys / 16][4] = {};
  const uint32_t qa = smem_u32(sq) + c * 64 * 128;
  const uint32_t da = smem_u32(sdo) + c * 64 * 128;
  mbar_wait(qfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    ring.wait(i);
    const int k0 = (kt_lo + i) * T::kKeys;
    if (k0 < hi_w && k0 + T::kKeys > lo_w) {
      const uint32_t kb =
          smem_u32(stages + (i % T::kStages) * T::STAGE_BYTES);
      const uint32_t vb = kb + T::KV_BYTES;
      // S = Q K^T, then dP = dO V^T (B K-major), two groups: 16 columns of
      // D a step, box ks / 4
      fence_acc(s);
      fence_acc(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t qo = (ks / 4) * T::kRows * 128 + (ks % 4) * 32;
        const uint32_t ko = (ks / 4) * T::kKeys * 128 + (ks % 4) * 32;
        if constexpr (LC_BWD_PROBE != 2 && LC_BWD_PROBE != 3)
          wgmma_ss_bf16<0>(s, kmajor(qa + qo), kmajor(kb + ko), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t qo = (ks / 4) * T::kRows * 128 + (ks % 4) * 32;
        const uint32_t ko = (ks / 4) * T::kKeys * 128 + (ks % 4) * 32;
        if constexpr (LC_BWD_PROBE != 2 && LC_BWD_PROBE != 3)
          wgmma_ss_bf16<0>(dp, kmajor(da + qo), kmajor(vb + ko), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S
      fence_acc(s);

      // P (times the cap's factor; masked: 0) into s while dP runs; the
      // mask only on the band's and the tensors' edges
      const bool edge = k0 + T::kKeys > Nk ||
                        (causal && k0 + T::kKeys - 1 > r0) ||
                        (window > 0 && r0 + 63 - k0 >= window);
#pragma unroll
      for (int n = 0; n < T::kKeys / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * n + 2 * j + e;
            float capf;
            const float p = prob<kCap>(s[x], lse2[j], kc, capf);
            s[x] = edge && !keep(r0 + warp * 16 + g + 8 * j,
                                 k0 + 8 * n + 2 * t + e, Nq, Nk, causal,
                                 window)
                       ? 0.f
                       : p * capf;
          }
      wgmma_wait<0>();  // dP
      fence_acc(dp);
      // dS = P (dP - delta) as bf16 A fragments
#pragma unroll
      for (int n = 0; n < T::kKeys / 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * n + 2 * j;
          dsa[n / 2][2 * (n % 2) + j] = pack_bf16x2(
              s[x] * (dp[x] - dl[j]), s[x + 1] * (dp[x + 1] - dl[j]));
        }

      // dQ += dS K: K as B, MN-major (16 keys a step)
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kKeys / 16; ++kk)
        if constexpr (LC_BWD_PROBE != 2)
          wgmma_rs_bf16<1>(acc, dsa[kk],
                           mnmajor(kb + kk * 2048, T::kKeys * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      fence_frag(dsa);
    }
    ring.release(i, n_tiles, lane, issue);
  }

  uint16_t* dqb = dq + rows0 * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + warp * 16 + g + 8 * i;
    if (row >= Nq) continue;
    uint16_t* orow = dqb + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) = pack_bf16x2(
          acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
  }
}

// ----------------------------------------------------------------- dK/dV

// The shared memory and the loads of both dK/dV kernels: K and V once
// behind ``kvfull``, then for every q head of the group
// the q tiles [qt_lo, qt_lo + n_qt): Q and dO by TMA, lse2 and delta of the
// tile's rows by bulk copies from the rows buffer.
template <class T>
struct DkvSmem {
  uint8_t *sk, *sv, *stages, *xch, *rowbuf;
  uint64_t *kvfull, *full;
  int* released;
  __device__ explicit DkvSmem(uint8_t* raw) {
    uint8_t* smem = align1024(raw);
    sk = smem;
    sv = sk + T::KV_BYTES;
    stages = sv + T::KV_BYTES;
    xch = stages + T::kStages * T::STAGE_BYTES;
    rowbuf = xch + T::XCH_BYTES;
    kvfull = reinterpret_cast<uint64_t*>(rowbuf +
                                         T::kStages * 2 * T::ROW_BYTES);
    full = kvfull + 1;
    released = reinterpret_cast<int*>(full + T::kStages);
  }
  __device__ uint8_t* stage(int i) const {
    return stages + (i % T::kStages) * T::STAGE_BYTES;
  }
  // lse2 then delta of tile i's q rows
  __device__ float* rows(int i) const {
    return reinterpret_cast<float*>(rowbuf + (i % T::kStages) * 2 *
                                                 T::ROW_BYTES);
  }
};

template <class T>
__device__ __forceinline__ void dkv_start(const Maps& maps,
                                          const DkvSmem<T>& sm, int k0) {
  prefetch_map(&maps.q);
  prefetch_map(&maps.dout);
  mbar_expect_tx(sm.kvfull, 2 * T::KV_BYTES);
#pragma unroll
  for (int j = 0; j < T::kBoxes; ++j) {
    tma_load_3d(sm.sk + j * T::kKeys * 128, &maps.k, sm.kvfull, 64 * j, k0,
                blockIdx.y);
    tma_load_3d(sm.sv + j * T::kKeys * 128, &maps.v, sm.kvfull, 64 * j, k0,
                blockIdx.y);
  }
}

template <class T>
__device__ __forceinline__ void dkv_issue(const Maps& maps,
                                          const DkvSmem<T>& sm,
                                          const float* rows, int npad, int bh,
                                          int q0, int s, uint64_t* bar) {
  mbar_expect_tx(bar, T::LOAD_BYTES);
  uint8_t* st = sm.stages + s * T::STAGE_BYTES;
#pragma unroll
  for (int j = 0; j < T::kBoxes; ++j) {
    tma_load_3d(st + j * T::kRowsQ * 128, &maps.q, bar, 64 * j, q0, bh);
    tma_load_3d(st + T::Q_BYTES + j * T::kRowsQ * 128, &maps.dout, bar,
                64 * j, q0, bh);
  }
  const float* src = rows + static_cast<size_t>(bh) * 2 * npad + q0;
  float* dst = sm.rows(s);
  bulk_load(dst, src, T::ROW_BYTES, bar);
  bulk_load(dst + T::kRowsQ, src + npad, T::ROW_BYTES, bar);
}

// The joint kernel (head dims 64 and 128).
template <int D, bool kCap>
__global__ void __launch_bounds__(DkvTile<D>::THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ Maps maps,
                     const float* __restrict__ rows,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                     int H, int Hkv, int Nq, int Nk, float scale, int causal,
                     int window, float softcap) {
  using T = DkvTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const DkvSmem<T> sm(smem_raw);

  const int k0 = blockIdx.x * T::kKeys;  // causal: the first are heaviest
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv, group = H / Hkv;
  int lo, hi;
  row_range(k0, k0 + T::kKeys, Nq, Nk, causal, window, lo, hi);
  const int qt_lo = lo / T::kRowsQ;
  const int n_qt = hi > lo ? cdiv(hi, T::kRowsQ) - qt_lo : 0;
  const int npad = rows_pad(Nq);
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int n_tiles = group * n_qt;
  const Ring<T::kStages, 4 * T::kCons> ring{sm.full, sm.released};

  if (threadIdx.x == 0) {
    mbar_init(sm.kvfull, 1);
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i, int s, uint64_t* bar) {
    dkv_issue<T>(maps, sm, rows, npad, b * H + kvh * group + i / n_qt,
                 (qt_lo + i % n_qt) * T::kRowsQ, s, bar);
  };
  if (threadIdx.x == 0) {
    dkv_start<T>(maps, sm, k0);
    ring.start(n_tiles, issue);
  }

  // this warpgroup's keys [kc0, kc0 + 64)
  const int kc0 = k0 + 64 * c;
  const Consts kc{scale * kLog2e, kCap ? scale / softcap : 0.f,
                  softcap * kLog2e};
  int lo_w, hi_w;  // this warpgroup's q rows
  row_range(kc0, kc0 + 64, Nq, Nk, causal, window, lo_w, hi_w);

  float dka[D / 2], dva[D / 2], st[T::kRowsQ / 2], dpt[T::kRowsQ / 2];
  zero(dka);
  zero(dva);
  zero(st);
  zero(dpt);
  uint32_t pa[T::kRowsQ / 16][4] = {}, dsa[T::kRowsQ / 16][4] = {};
  const uint32_t ka = smem_u32(sm.sk) + c * 64 * 128;
  const uint32_t va = smem_u32(sm.sv) + c * 64 * 128;
  mbar_wait(sm.kvfull, 0);
  for (int i = 0; i < n_tiles; ++i) {
    ring.wait(i);
    const int q0 = (qt_lo + i % n_qt) * T::kRowsQ;
    if (q0 < hi_w && q0 + T::kRowsQ > lo_w) {
      const uint32_t qb = smem_u32(sm.stage(i));
      const uint32_t db = qb + T::Q_BYTES;
      const float* sr = sm.rows(i);
      // S^T = K Q^T and dP^T = V dO^T (B K-major), two groups: P^T is
      // formed while dP^T runs, and dV issued before dS^T is formed
      fence_acc(st);
      fence_acc(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t ko = (ks / 4) * T::kKeys * 128 + (ks % 4) * 32;
        const uint32_t qo = (ks / 4) * T::kRowsQ * 128 + (ks % 4) * 32;
        if constexpr (LC_BWD_PROBE != 2 && LC_BWD_PROBE != 3)
          wgmma_ss_bf16<0>(st, kmajor(ka + ko), kmajor(qb + qo), ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t ko = (ks / 4) * T::kKeys * 128 + (ks % 4) * 32;
        const uint32_t qo = (ks / 4) * T::kRowsQ * 128 + (ks % 4) * 32;
        if constexpr (LC_BWD_PROBE != 2 && LC_BWD_PROBE != 3)
          wgmma_ss_bf16<0>(dpt, kmajor(va + ko), kmajor(db + qo), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // S^T
      fence_acc(st);

      // P^T as bf16 A fragments over the q rows; st keeps P^T times the
      // cap's factor (masked: 0) for dS^T
      const bool edge = q0 + T::kRowsQ > Nq || kc0 + 64 > Nk ||
                        (causal && q0 < kc0 + 63) ||
                        (window > 0 && q0 + T::kRowsQ - 1 - kc0 >= window);
#pragma unroll
      for (int n = 0; n < T::kRowsQ / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(sr + 8 * n + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = 4 * n + 2 * j + e;
            float capf;
            p[e] = prob<kCap>(st[x], e ? l2.y : l2.x, kc, capf);
            if (edge && !keep(q0 + 8 * n + 2 * t + e,
                              kc0 + warp * 16 + g + 8 * j, Nq, Nk, causal,
                              window))
              p[e] = 0.f;
            st[x] = p[e] * capf;
          }
          pa[n / 2][2 * (n % 2) + j] = pack_bf16x2(p[0], p[1]);
        }
      }

      // dV += P^T dO (B MN-major, 16 q rows a step)
      fence_acc(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kRowsQ / 16; ++kk)
        if constexpr (LC_BWD_PROBE != 2)
          wgmma_rs_bf16<1>(dva, pa[kk],
                           mnmajor(db + kk * 2048, T::kRowsQ * 128), 1);
      wgmma_commit();

      // dS^T = P^T (dP^T - delta) (times the cap's factor), then dK +=
      // dS^T Q
      wgmma_wait<1>();  // dP^T (dV may still run)
      fence_acc(dpt);
#pragma unroll
      for (int n = 0; n < T::kRowsQ / 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(sr + T::kRowsQ + 8 * n + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int x = 4 * n + 2 * j;
          dsa[n / 2][2 * (n % 2) + j] = pack_bf16x2(
              st[x] * (dpt[x] - d2.x), st[x + 1] * (dpt[x + 1] - d2.y));
        }
      }
      fence_acc(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kRowsQ / 16; ++kk)
        if constexpr (LC_BWD_PROBE != 2)
          wgmma_rs_bf16<1>(dka, dsa[kk],
                           mnmajor(qb + kk * 2048, T::kRowsQ * 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dka);
      fence_acc(dva);
      fence_frag(pa);
      fence_frag(dsa);
    }
    ring.release(i, n_tiles, lane, issue);
  }

  const size_t keys0 = static_cast<size_t>(blockIdx.y) * Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kc0 + warp * 16 + g + 8 * i;
    if (key >= Nk) continue;
    const size_t off = (keys0 + key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack_bf16x2(
          dka[4 * n + 2 * i] * scale, dka[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack_bf16x2(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
    }
  }
}

// The split-D kernel (head dim 256): two consumer warpgroups share 64 keys;
// warpgroup c accumulates columns [128 c, 128 c + 128) of dK and dV.
// Per q tile: warpgroup 0 issues S^T, warpgroup 1 dP^T; warpgroup 0 writes
// P^T (bf16, swizzled K-major: row = key, 128 bytes of q rows) and P^T
// times the cap's factor (f32, thread order); named barrier 1; warpgroup 1
// writes dS^T = that (dP^T - delta) (bf16, swizzled); named barrier 2; both
// issue their halves of dV += P^T dO and dK += dS^T Q from shared memory.
// Named barrier 3 (warpgroup 1 arrives once its products have read P^T)
// keeps warpgroup 0 from overwriting P^T early.
template <bool kCap>
__global__ void __launch_bounds__(256, 1)
flash_bwd_dkv_split_kernel(const __grid_constant__ Maps maps,
                           const float* __restrict__ rows,
                           uint16_t* __restrict__ dk,
                           uint16_t* __restrict__ dv, int H, int Hkv, int Nq,
                           int Nk, float scale, int causal, int window,
                           float softcap) {
  constexpr int D = 256;
  using T = DkvTile<D>;
  constexpr int R = T::kRowsQ;
  extern __shared__ uint8_t smem_raw[];
  const DkvSmem<T> sm(smem_raw);
  uint8_t* sp = sm.xch;                                  // P^T, bf16
  uint8_t* sds = sp + 64 * R * 2;                        // dS^T, bf16
  float* xch = reinterpret_cast<float*>(sds + 64 * R * 2);  // f32, 64 x R

  const int k0 = blockIdx.x * 64;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv, group = H / Hkv;
  int lo, hi;
  row_range(k0, k0 + 64, Nq, Nk, causal, window, lo, hi);
  const int qt_lo = lo / R, n_qt = hi > lo ? cdiv(hi, R) - qt_lo : 0;
  const int n_tiles = group * n_qt;
  const int npad = rows_pad(Nq);
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const Ring<T::kStages, 8> ring{sm.full, sm.released};

  if (threadIdx.x == 0) {
    mbar_init(sm.kvfull, 1);
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i, int s, uint64_t* bar) {
    dkv_issue<T>(maps, sm, rows, npad, b * H + kvh * group + i / n_qt,
                 (qt_lo + i % n_qt) * R, s, bar);
  };
  if (threadIdx.x == 0) {
    dkv_start<T>(maps, sm, k0);
    ring.start(n_tiles, issue);
  }

  const Consts kc{scale * kLog2e, kCap ? scale / softcap : 0.f,
                  softcap * kLog2e};
  float dka[64], dva[64], x[R / 2];
  zero(dka);
  zero(dva);
  zero(x);
  // S^T from K (warpgroup 0) or dP^T from V (warpgroup 1), all 64 keys
  const uint32_t a_op = smem_u32(c == 0 ? sm.sk : sm.sv);
  const uint32_t spa = smem_u32(sp), sdsa = smem_u32(sds);
  mbar_wait(sm.kvfull, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = (qt_lo + it % n_qt) * R;
    ring.wait(it);
    const uint32_t qb = smem_u32(sm.stage(it));
    const uint32_t db = qb + T::Q_BYTES;
    const float* sr = sm.rows(it);
    fence_acc(x);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t ko = (ks / 4) * 64 * 128 + (ks % 4) * 32;
      const uint32_t qo = (ks / 4) * R * 128 + (ks % 4) * 32;
      if constexpr (LC_BWD_PROBE != 2 && LC_BWD_PROBE != 3)
        wgmma_ss_bf16<0>(x, kmajor(a_op + ko),
                         kmajor((c == 0 ? qb : db) + qo), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(x);

    const bool edge = q0 + R > Nq || k0 + 64 > Nk ||
                      (causal && q0 < k0 + 63) ||
                      (window > 0 && q0 + R - 1 - k0 >= window);
    if (c == 0) {
      if (it > 0) named_sync(3, 256);  // warpgroup 1 has read P^T
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        const float2 l2 = *reinterpret_cast<const float2*>(sr + 8 * n + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key_l = warp * 16 + g + 8 * j;
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float capf;
            p[e] = prob<kCap>(x[4 * n + 2 * j + e], e ? l2.y : l2.x, kc,
                              capf);
            if (edge && !keep(q0 + 8 * n + 2 * t + e, k0 + key_l, Nq, Nk,
                              causal, window))
              p[e] = 0.f;
            xch[(4 * n + 2 * j + e) * 128 + tid] = p[e] * capf;
          }
          *reinterpret_cast<uint32_t*>(
              sp + key_l * 128 + ((n ^ (key_l % 8)) * 16) + 4 * t) =
              pack_bf16x2(p[0], p[1]);
        }
      }
      fence_proxy_async_shared();
      named_sync(1, 256);
      named_sync(2, 256);
    } else {
      named_sync(1, 256);
#pragma unroll
      for (int n = 0; n < R / 8; ++n) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(sr + R + 8 * n + 2 * t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key_l = warp * 16 + g + 8 * j, y = 4 * n + 2 * j;
          *reinterpret_cast<uint32_t*>(
              sds + key_l * 128 + ((n ^ (key_l % 8)) * 16) + 4 * t) =
              pack_bf16x2(xch[y * 128 + tid] * (x[y] - d2.x),
                          xch[(y + 1) * 128 + tid] * (x[y + 1] - d2.y));
        }
      }
      fence_proxy_async_shared();
      named_sync(2, 256);
    }

    // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half]
    const uint32_t half = 2 * c * R * 128;  // boxes 2c and 2c + 1
    fence_acc(dka);
    fence_acc(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      if constexpr (LC_BWD_PROBE != 2) {
        wgmma_ss_bf16<1>(dva, kmajor(spa + kk * 32),
                         mnmajor(db + half + kk * 2048, R * 128), 1);
        wgmma_ss_bf16<1>(dka, kmajor(sdsa + kk * 32),
                         mnmajor(qb + half + kk * 2048, R * 128), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
    if (c == 1 && it + 1 < n_tiles)
      asm volatile("bar.arrive 3, 256;" ::: "memory");
    ring.release(it, n_tiles, lane, issue);
  }

  const size_t keys0 = static_cast<size_t>(blockIdx.y) * Nk;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + warp * 16 + g + 8 * i;
    if (key >= Nk) continue;
    const size_t off = (keys0 + key) * D + 128 * c + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n) = pack_bf16x2(
          dka[4 * n + 2 * i] * scale, dka[4 * n + 2 * i + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
          pack_bf16x2(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
    }
  }
}

// --------------------------------------------------------------- launches

int make_maps(Maps& m, const void* q, const void* k, const void* v,
              const void* dout, int BH, int BHkv, int Nq, int Nk, int D,
              int q_rows, int kv_rows) {
  int err = map_3d(&m.q, q, false, BH, Nq, D, q_rows, 64);
  if (!err) err = map_3d(&m.dout, dout, false, BH, Nq, D, q_rows, 64);
  if (!err) err = map_3d(&m.k, k, false, BHkv, Nk, D, kv_rows, 64);
  if (!err) err = map_3d(&m.v, v, false, BHkv, Nk, D, kv_rows, 64);
  return err;
}

template <class Kern>
int prepare(Kern kern, int smem, unsigned long long& devices) {
  return static_cast<int>(smem_limit_per_device(kern, smem, devices));
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const void* lse, const void* dlse,
              void* rows, void* dq, int B, int H, int Hkv, int Nq, int Nk,
              float scale, int causal, int window, float softcap,
              cudaStream_t stream) {
  using T = DqTile<D>;
  static unsigned long long dev_cap = 0, dev_plain = 0;
  const bool cap = softcap > 0.f;
  auto kern =
      cap ? flash_bwd_dq_kernel<D, true> : flash_bwd_dq_kernel<D, false>;
  if (int e = prepare(kern, T::SMEM_BYTES, cap ? dev_cap : dev_plain))
    return e;
  Maps maps;
  if (int e = make_maps(maps, q, k, v, dout, B * H, B * Hkv, Nq, Nk, D,
                        T::kRows, T::kKeys))
    return e;
  dim3 grid(cdiv(Nq, T::kRows), B * H);
  kern<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      maps, static_cast<const uint16_t*>(out),
      static_cast<const uint16_t*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<float*>(rows),
      static_cast<uint16_t*>(dq), H, Hkv, Nq, Nk, scale, causal || window > 0,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <class T, class Kern>
int start_dkv(Kern kern, unsigned long long& devices, const Maps& maps,
              const void* rows, void* dk, void* dv, int B, int H, int Hkv,
              int Nq, int Nk, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  if (int e = prepare(kern, T::SMEM_BYTES, devices)) return e;
  dim3 grid(cdiv(Nk, T::kKeys), B * Hkv);
  kern<<<grid, T::THREADS, T::SMEM_BYTES, stream>>>(
      maps, static_cast<const float*>(rows), static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), H, Hkv, Nq, Nk, scale, causal || window > 0,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* rows, void* dk, void* dv, int B, int H, int Hkv,
               int Nq, int Nk, float scale, int causal, int window,
               float softcap, cudaStream_t stream) {
  using T = DkvTile<D>;
  Maps maps;
  if (int e = make_maps(maps, q, k, v, dout, B * H, B * Hkv, Nq, Nk, D,
                        T::kRowsQ, T::kKeys))
    return e;
  static unsigned long long dev_cap = 0, dev_plain = 0;
  const bool cap = softcap > 0.f;
  if constexpr (T::kSplit) {
    auto kern = cap ? flash_bwd_dkv_split_kernel<true>
                    : flash_bwd_dkv_split_kernel<false>;
    return start_dkv<T>(kern, cap ? dev_cap : dev_plain, maps, rows, dk, dv,
                        B, H, Hkv, Nq, Nk, scale, causal, window, softcap,
                        stream);
  } else {
    auto kern =
        cap ? flash_bwd_dkv_kernel<D, true> : flash_bwd_dkv_kernel<D, false>;
    return start_dkv<T>(kern, cap ? dev_cap : dev_plain, maps, rows, dk, dv,
                        B, H, Hkv, Nq, Nk, scale, causal, window, softcap,
                        stream);
  }
}

bool bad_shape(int B, int H, int Hkv, int Nq, int Nk) {
  return B <= 0 || Hkv <= 0 || H % Hkv != 0 || B * H > 65535 || Nq <= 0 ||
         Nk <= 0;
}

template <int D>
void plan_info(int* info) {
  using Q = DqTile<D>;
  using K = DkvTile<D>;
  const int vals[9] = {Q::kRows, Q::kKeys,  Q::kStages, Q::SMEM_BYTES,
                       K::kKeys, K::kRowsQ, K::kStages, K::SMEM_BYTES,
                       K::kSplit ? 1 : 0};
  for (int i = 0; i < 9; ++i) info[i] = vals[i];
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 =
// launched), launch on ``stream``, do not synchronise and allocate nothing.
// ``window`` > 0 implies causal; ``window`` <= 0 and ``softcap`` <= 0 mean
// none (the forward's options, which produced ``lse``). Head dims 64, 128
// and 256; every bf16 operand 16-byte aligned. ``rows`` (B, H, 2,
// cdiv(Nq, 64) * 64) f32, written by the dQ launch: lse * log2(e), then
// delta = rowsum(dout * out) - dlse, zeros past Nq.

// dq (B, H, Nq, D) bf16 and ``rows`` (``dlse`` null: no lse cotangent).
extern "C" int lc_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    const void* dlse, void* rows, void* dq,
                                    int B, int H, int Hkv, int Nq, int Nk,
                                    int D, float scale, int causal,
                                    int window, float softcap, void* stream) {
  if (bad_shape(B, H, Hkv, Nq, Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, out, dout, lse, dlse, rows, dq, B, H,
                           Hkv, Nq, Nk, scale, causal, window, softcap, s);
    case 128:
      return launch_dq<128>(q, k, v, out, dout, lse, dlse, rows, dq, B, H,
                            Hkv, Nq, Nk, scale, causal, window, softcap, s);
    case 256:
      return launch_dq<256>(q, k, v, out, dout, lse, dlse, rows, dq, B, H,
                            Hkv, Nq, Nk, scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk, dv (B, Hkv, Nk, D) bf16, each summed over the q heads of its group;
// ``rows`` from the dQ launch.
extern "C" int lc_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* rows, void* dk, void* dv,
                                     int B, int H, int Hkv, int Nq, int Nk,
                                     int D, float scale, int causal,
                                     int window, float softcap,
                                     void* stream) {
  if (bad_shape(B, H, Hkv, Nq, Nk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, rows, dk, dv, B, H, Hkv, Nq, Nk,
                            scale, causal, window, softcap, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, rows, dk, dv, B, H, Hkv, Nq, Nk,
                             scale, causal, window, softcap, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, rows, dk, dv, B, H, Hkv, Nq, Nk,
                             scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The plan this build launches at head dim D: info = {dQ rows, dQ keys, dQ
// stages, dQ shared bytes, dK/dV keys, dK/dV q rows, dK/dV stages, dK/dV
// shared bytes, split}. Returns a CUDA error code.
extern "C" int lc_flash_bwd_plan(int D, int* info) {
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
