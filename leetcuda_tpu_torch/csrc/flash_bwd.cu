// Flash-attention backward (FA-2) for Hopper, bf16: the dQ and dK/dV kernels.
//
// Replaces: leetcuda_tpu/attention/flash_bwd.py _bwd, its two pallas_calls:
// _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK, dV). Both recompute
// P = exp(S * scale - lse) from the forward's saved log-sum-exp (no N x N
// residual) and take delta = rowsum(dO * O) - dlse from the wrapper (a torch
// op outside the kernels, as flash_bwd.py:176 is a jnp op outside Pallas):
//   dP = dO V^T,  dS = P * (dP - delta),
//   dQ = scale * dS K,  dV = P^T dO,  dK = scale * dS^T Q.
//
// With ``softcap`` > 0 the forward capped each scaled score, c = cap *
// tanh(s * scale / cap), so P = exp(c - lse) is recomputed from c and the
// chain rule through the cap multiplies dS by 1 - (c / cap)^2 = 1 - tanh^2
// (flash_bwd.py:56-57, 72-73): the capped, pre-mask value; masked entries
// have P = 0. ``window`` > 0 keeps the forward's band rows - cols < window
// (flash_bwd.py:63-64); both kernels skip the tiles off the band: dQ starts
// its key walk at the band of the q tile's first row (flash_bwd.py:81-82),
// dK/dV stops its q walk at the band's end (flash_bwd.py:140-141).
//
// Layouts are the forward's: q, o, do, dq (B, H, Nq, D); k, v, dk, dv
// (B, Hkv, Nk, D), all contiguous bf16; lse, delta (B, H, Nq) f32. GQA:
// q head h reads kv head h / (H / Hkv).
//
// Bound on an H100 SXM: operations. At (8, 16, 2048, 128) causal the dQ
// kernel runs three products (Q.K^T, dO.V^T, dS.K) and the dK/dV kernel
// four (K.Q^T, V.dO^T, P^T.dO, dS^T.Q), each 2 * B * H * N^2 * D / 2 FLOPs:
// 0.208 and 0.278 ms at the 989 TFLOP/s bf16 tensor-core peak, against
// ~0.06 ms of memory at 3.35 TB/s.
//
// Design, simple first, laid out as the forward (csrc/flash_fwd.cu):
// * dQ: one CTA of four warps per (64-row q tile, b * h); each warp keeps 16
//   rows of Q and dO as mma fragments, their lse and delta, and the 16 x D
//   dQ accumulator (f32) in registers, and walks 64-key tiles of K and V in
//   padded shared memory up to the causal limit, in two halves of 32 keys
//   (S and dP of 16 x 32 keep the registers under the limit). dS reaches
//   dS.K in registers, as the forward hands P to P.V.
// * dK/dV: one CTA per (64-key tile, b * kv head), not per q head: it walks
//   every q head of the group and, for each, the q tiles from the causal
//   start, so dK and dV sum the whole group in f32 registers (16 keys x D
//   each per warp) and are written once: no repeat of k/v, no group sum
//   afterwards, no atomics, a deterministic result. K, V and the current q
//   tile's Q, dO, lse and delta live in (dynamic) shared memory; A
//   fragments of K and V are read per k-step, and the q tile is consumed
//   in two halves of 32 rows, for the same register reason.
// * Head dim 256: a thread's 16 x D accumulator is 128 f32 registers, and
//   dK/dV's two are 256, past the 255 a thread may hold. So the dQ kernel
//   reads its Q and dO fragments from the q tile in shared memory instead
//   of holding them (128 more registers) and walks 32-key tiles; and dK
//   and dV are computed by two launches of the dK/dV kernel, one for each
//   output (kOut): the dV launch recomputes S^T only, the dK launch S^T and
//   dP^T, so the split costs one product in five (S^T again), where
//   splitting the output columns across CTAs would recompute both S^T and
//   dP^T (two in six), and shared-memory accumulators would pay a load and
//   a store around every mma. Both launches stage the same tiles (135 KB of
//   dynamic shared memory; the dV launch leaves V out), walk each q tile in
//   steps of 16 rows (S^T and dP^T of 16 x 16 a warp), are as
//   deterministic as the joint kernel and need no atomics. Head dims 64
//   and 128 keep the joint kernel and the registers Q and dO of the dQ
//   kernel.
// mma.sync m16n8k16 (bf16 in, f32 accumulate) throughout; P and dS are
// rounded to bf16 before the second products, as the TPU kernel casts them.
// The cap is a compile-time flag (kCap, tanhf): the uncapped kernels carry
// no tanh.
// wgmma, TMA and a pipelined tile are later work.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;    // q rows of a tile
constexpr int kBK = 64;    // keys of a tile
constexpr int kSub = 32;   // keys (dQ) or q rows (dK/dV) per inner step
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* base, int row,
                                            int nrows, int col, int D) {
  if (row >= nrows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + col);
}

using lc::lds32;
using lc::lds_a;

// Two keys (rows r, r + 1) of one column as a bf16x2 B-fragment register.
__device__ __forceinline__ uint32_t col_pair(const uint16_t* p, int lds) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[lds]) << 16);
}

// rows [row0, row0 + kRows) of a (nrows, D) matrix into padded smem; rows
// past nrows stage as zeros
template <int D, int kRows>
__device__ __forceinline__ void stage(uint16_t* dst, const uint16_t* src,
                                      int row0, int nrows) {
  constexpr int LDS = D + 8;
  for (int i = threadIdx.x; i < kRows * (D / 8); i += kThreads) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + row < nrows)
      x = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + row) * D + col);
    *reinterpret_cast<uint4*>(dst + row * LDS + col) = x;
  }
}

// The dQ kernel at head dim 256 keeps Q and dO in shared memory and walks
// 32-key tiles (see the design note); its dynamic shared memory holds the
// K and V tiles and the q tile's Q and dO. 0 below 256: static K and V.
__host__ __device__ constexpr bool dq_smem_q(int D) { return D > 128; }
__host__ __device__ constexpr int dq_key_tile(int D) {
  return dq_smem_q(D) ? kSub : kBK;
}
__host__ __device__ constexpr int dq_smem_bytes(int D) {
  return dq_smem_q(D) ? (2 * dq_key_tile(D) + 2 * kBQ) * (D + 8) * 2 : 0;
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int H, int Hkv, int Nq, int Nk,
                    float scale, int causal, int window, float softcap) {
  constexpr bool kSmemQ = dq_smem_q(D);  // Q and dO fragments from smem
  constexpr int kKT = dq_key_tile(D);    // keys per tile
  constexpr int LDS = D + 8;
  constexpr int KSTEPS = D / 16;  // k-steps over the head dim
  constexpr int DT = D / 8;       // n-tiles of dQ
  constexpr int NT = kSub / 8;    // n-tiles of S and dP per half
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t *sk, *sv, *sq = nullptr, *sdo = nullptr;
  if constexpr (kSmemQ) {
    sk = smem;
    sv = sk + kKT * LDS;
    sq = sv + kKT * LDS;
    sdo = sq + kBQ * LDS;
  } else {
    __shared__ __align__(16) uint16_t ssk[kBK * LDS];
    __shared__ __align__(16) uint16_t ssv[kBK * LDS];
    sk = ssk;
    sv = ssv;
  }

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest tiles first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const float scale_over_cap = kCap ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;

  const uint16_t* qb = q + (size_t)bh * Nq * D;
  const uint16_t* dob = dout + (size_t)bh * Nq * D;
  const uint16_t* kb = k + (size_t)(b * Hkv + kvh) * Nk * D;
  const uint16_t* vb = v + (size_t)(b * Hkv + kvh) * Nk * D;

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[kSmemQ ? 1 : KSTEPS][4], da[kSmemQ ? 1 : KSTEPS][4];
  if constexpr (kSmemQ) {
    // the q tile's Q and dO, rows past Nq as zeros; the first key tile's
    // barrier publishes them
    stage<D, kBQ>(sq, qb, q0, Nq);
    stage<D, kBQ>(sdo, dob, q0, Nq);
  } else {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + t * 2;
      qa[ks][0] = ld_pair(qb, r0, Nq, c, D);
      qa[ks][1] = ld_pair(qb, r0 + 8, Nq, c, D);
      qa[ks][2] = ld_pair(qb, r0, Nq, c + 8, D);
      qa[ks][3] = ld_pair(qb, r0 + 8, Nq, c + 8, D);
      da[ks][0] = ld_pair(dob, r0, Nq, c, D);
      da[ks][1] = ld_pair(dob, r0 + 8, Nq, c, D);
      da[ks][2] = ld_pair(dob, r0, Nq, c + 8, D);
      da[ks][3] = ld_pair(dob, r0 + 8, Nq, c + 8, D);
    }
  }
  float lse2[2], dl[2];  // lse in the log2 domain, delta; rows past Nq: 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    const bool in = row < Nq;
    lse2[i] = in ? lse[(size_t)bh * Nq + row] * kLog2e : 0.f;
    dl[i] = in ? delta[(size_t)bh * Nq + row] : 0.f;
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // causal key tiles past the q tile's last row are skipped, and with a
  // window those left of its first row's band (flash_bwd.py:79-87)
  int kv_end = Nk;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_tiles = (kv_end + kKT - 1) / kKT;
  const int kt0 = window > 0 ? max(q0 - window + 1, 0) / kKT : 0;

  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKT;
    __syncthreads();  // the previous tile's readers are done
    stage<D, kKT>(sk, kb, k0, Nk);
    stage<D, kKT>(sv, vb, k0, Nk);
    __syncthreads();

#pragma unroll
    for (int half = 0; half < kKT / kSub; ++half) {
      const int kh = half * kSub;  // first key of this half in the tile
      // S = Q K^T and dP = dO V^T, 16 rows x 32 keys per warp, f32
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const uint32_t* aq = qa[kSmemQ ? 0 : ks];
        const uint32_t* ad = da[kSmemQ ? 0 : ks];
        uint32_t qf[4], df[4];
        if constexpr (kSmemQ) {
          const int aoff = (warp * 16 + g) * LDS + ks * 16 + t * 2;
          lds_a(qf, sq + aoff, LDS);
          lds_a(df, sdo + aoff, LDS);
          aq = qf;
          ad = df;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int off = (kh + nt * 8 + g) * LDS + ks * 16 + t * 2;
          const uint32_t bk[2] = {lds32(sk + off), lds32(sk + off + 8)};
          const uint32_t bv[2] = {lds32(sv + off), lds32(sv + off + 8)};
          lc::mma_bf16_16816(s[nt], aq, bk);
          lc::mma_bf16_16816(dp[nt], ad, bv);
        }
      }

      // P = exp(S * scale - lse) (masked: 0), dS = P (dP - delta) in bf16
      // A fragments (the C layout of S is the A layout of dS, key by key);
      // kCap: P from the capped score, dS times 1 - tanh^2
      uint32_t dsa[kSub / 16][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (e >= 2 ? 8 : 0);
          const int col = k0 + kh + nt * 8 + t * 2 + (e & 1);
          const bool keep = col < Nk && (!causal || col <= row) &&
                            (window <= 0 || row - col < window);
          if constexpr (kCap) {
            const float th = tanhf(s[nt][e] * scale_over_cap);
            const float p = keep ? exp2f(th * cap_log2 - lse2[e >> 1]) : 0.f;
            ds[e] = p * (dp[nt][e] - dl[e >> 1]) * (1.f - th * th);
          } else {
            const float p =
                keep ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
            ds[e] = p * (dp[nt][e] - dl[e >> 1]);
          }
        }
        dsa[nt / 2][(nt % 2) * 2 + 0] = lc::pack_bf16x2(ds[0], ds[1]);
        dsa[nt / 2][(nt % 2) * 2 + 1] = lc::pack_bf16x2(ds[2], ds[3]);
      }

      // dQ += dS K: B fragments gather two keys of one column from smem
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
        const uint16_t* kr = sk + (kh + kk * 16 + t * 2) * LDS + g;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          const uint16_t* kc = kr + dt * 8;
          const uint32_t bf[2] = {col_pair(kc, LDS),
                                  col_pair(kc + 8 * LDS, LDS)};
          lc::mma_bf16_16816(acc[dt], dsa[kk], bf);
        }
      }
    }
  }

  uint16_t* dqb = dq + (size_t)bh * Nq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= Nq) continue;
    uint16_t* orow = dqb + (size_t)row * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = lc::pack_bf16x2(
          acc[dt][2 * i] * scale, acc[dt][2 * i + 1] * scale);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  // K, V (kBK rows) and Q, dO (kBQ rows), padded, then lse2 and delta
  return (2 * kBK + 2 * kBQ) * (D + 8) * 2 + 2 * kBQ * 4;
}

// kOut: which outputs a launch computes, kDV | kDK (see the design note).
constexpr int kDV = 1, kDK = 2;

template <int D, bool kCap, int kOut>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const uint16_t* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                     int H, int Hkv, int Nq, int Nk, float scale, int causal,
                     int window, float softcap) {
  constexpr int LDS = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int DT = D / 8;
  // q rows per inner step: 32, and 16 at head dim 256 (its 128 accumulator
  // registers leave less room for S^T and dP^T)
  constexpr int kQS = D > 128 ? 16 : kSub;
  constexpr int NT = kQS / 8;  // n-tiles of S^T and dP^T per step
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sk = smem;
  uint16_t* sv = sk + kBK * LDS;
  uint16_t* sq = sv + kBK * LDS;
  uint16_t* sdo = sq + kBQ * LDS;
  float* slse = reinterpret_cast<float*>(sdo + kBQ * LDS);
  float* sdl = slse + kBQ;

  const int k0 = blockIdx.x * kBK;  // causal: the first key tiles are heaviest
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv, kvh = bkv % Hkv;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const float scale_over_cap = kCap ? scale / softcap : 0.f;
  const float cap_log2 = softcap * kLog2e;

  constexpr bool kWantV = kOut & kDV, kWantK = kOut & kDK;
  stage<D, kBK>(sk, k + (size_t)bkv * Nk * D, k0, Nk);
  if constexpr (kWantK)  // V enters dP^T only
    stage<D, kBK>(sv, v + (size_t)bkv * Nk * D, k0, Nk);

  const int kl = warp * 16 + g;  // this thread's keys: kl and kl + 8 (local)
  float dka[kWantK ? DT : 1][4], dva[kWantV ? DT : 1][4];
#pragma unroll
  for (int dt = 0; dt < (kWantK ? DT : 1); ++dt)
    dka[dt][0] = dka[dt][1] = dka[dt][2] = dka[dt][3] = 0.f;
#pragma unroll
  for (int dt = 0; dt < (kWantV ? DT : 1); ++dt)
    dva[dt][0] = dva[dt][1] = dva[dt][2] = dva[dt][3] = 0.f;

  // causal q tiles that end before this key tile see none of it, and with
  // a window neither do those that start past the band of its last key,
  // row k0 + kBK - 2 + window (flash_bwd.py:137-145)
  const int qt0 = causal ? k0 / kBQ : 0;
  int n_qt = (Nq + kBQ - 1) / kBQ;
  if (window > 0) n_qt = min(n_qt, (k0 + kBK - 2 + window) / kBQ + 1);

  for (int hh = 0; hh < group; ++hh) {
    const int bh = b * H + kvh * group + hh;
    const uint16_t* qb = q + (size_t)bh * Nq * D;
    const uint16_t* dob = dout + (size_t)bh * Nq * D;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's readers are done
      stage<D, kBQ>(sq, qb, q0, Nq);
      stage<D, kBQ>(sdo, dob, q0, Nq);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        const bool in = row < Nq;
        slse[threadIdx.x] = in ? lse[(size_t)bh * Nq + row] * kLog2e : 0.f;
        sdl[threadIdx.x] = in ? delta[(size_t)bh * Nq + row] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int half = 0; half < kBQ / kQS; ++half) {
        const int qh = half * kQS;  // first q row of this step in the tile
        // S^T = K Q^T and dP^T = V dO^T, 16 keys x kQS q rows per warp
        float st[NT][4], dpt[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
          dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int aoff = kl * LDS + ks * 16 + t * 2;
          const uint32_t ka[4] = {lds32(sk + aoff), lds32(sk + aoff + 8 * LDS),
                                  lds32(sk + aoff + 8),
                                  lds32(sk + aoff + 8 * LDS + 8)};
          uint32_t va[4];
          if constexpr (kWantK) lds_a(va, sv + aoff, LDS);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int boff = (qh + nt * 8 + g) * LDS + ks * 16 + t * 2;
            const uint32_t bq[2] = {lds32(sq + boff), lds32(sq + boff + 8)};
            lc::mma_bf16_16816(st[nt], ka, bq);
            if constexpr (kWantK) {  // dP^T feeds dS^T only
              const uint32_t bd[2] = {lds32(sdo + boff),
                                      lds32(sdo + boff + 8)};
              lc::mma_bf16_16816(dpt[nt], va, bd);
            }
          }
        }

        // P^T = exp(S^T * scale - lse) (masked: 0), dS^T = P^T (dP^T -
        // delta), both as bf16 A fragments over the q rows
        uint32_t pa[kQS / 16][4], dsa[kQS / 16][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kl + (e >= 2 ? 8 : 0);
            const int ql = qh + nt * 8 + t * 2 + (e & 1);  // row in the tile
            const int row = q0 + ql;
            const bool keep = row < Nq && key < Nk &&
                              (!causal || row >= key) &&
                              (window <= 0 || row - key < window);
            if constexpr (kCap) {
              const float th = tanhf(st[nt][e] * scale_over_cap);
              p[e] = keep ? exp2f(th * cap_log2 - slse[ql]) : 0.f;
              if constexpr (kWantK)
                ds[e] = p[e] * (dpt[nt][e] - sdl[ql]) * (1.f - th * th);
            } else {
              p[e] = keep ? exp2f(st[nt][e] * scale_log2 - slse[ql]) : 0.f;
              if constexpr (kWantK) ds[e] = p[e] * (dpt[nt][e] - sdl[ql]);
            }
          }
          if constexpr (kWantV) {
            pa[nt / 2][(nt % 2) * 2 + 0] = lc::pack_bf16x2(p[0], p[1]);
            pa[nt / 2][(nt % 2) * 2 + 1] = lc::pack_bf16x2(p[2], p[3]);
          }
          if constexpr (kWantK) {
            dsa[nt / 2][(nt % 2) * 2 + 0] = lc::pack_bf16x2(ds[0], ds[1]);
            dsa[nt / 2][(nt % 2) * 2 + 1] = lc::pack_bf16x2(ds[2], ds[3]);
          }
        }

        // dV += P^T dO and dK += dS^T Q: B fragments gather two q rows of
        // one column from smem
#pragma unroll
        for (int kk = 0; kk < kQS / 16; ++kk) {
          const int roff = (qh + kk * 16 + t * 2) * LDS + g;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            if constexpr (kWantV) {
              const uint16_t* dc = sdo + roff + dt * 8;
              const uint32_t bd[2] = {col_pair(dc, LDS),
                                      col_pair(dc + 8 * LDS, LDS)};
              lc::mma_bf16_16816(dva[dt], pa[kk], bd);
            }
            if constexpr (kWantK) {
              const uint16_t* qc = sq + roff + dt * 8;
              const uint32_t bq[2] = {col_pair(qc, LDS),
                                      col_pair(qc + 8 * LDS, LDS)};
              lc::mma_bf16_16816(dka[dt], dsa[kk], bq);
            }
          }
        }
      }
    }
  }

  uint16_t* dkb = dk + (size_t)bkv * Nk * D;
  uint16_t* dvb = dv + (size_t)bkv * Nk * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kl + i * 8;
    if (key >= Nk) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const size_t off = (size_t)key * D + dt * 8 + t * 2;
      if constexpr (kWantK)
        *reinterpret_cast<uint32_t*>(dkb + off) = lc::pack_bf16x2(
            dka[dt][2 * i] * scale, dka[dt][2 * i + 1] * scale);
      if constexpr (kWantV)
        *reinterpret_cast<uint32_t*>(dvb + off) =
            lc::pack_bf16x2(dva[dt][2 * i], dva[dt][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int Nq, int Nk, float scale, int causal, int window,
              float softcap, cudaStream_t stream) {
  dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  auto kern = softcap > 0.f ? flash_bwd_dq_kernel<D, true>
                            : flash_bwd_dq_kernel<D, false>;
  constexpr int smem = dq_smem_bytes(D);
  if constexpr (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<uint16_t*>(dq), H, Hkv, Nq, Nk, scale,
      causal || window > 0, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int kOut>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Hkv, int Nq, int Nk, float scale, int causal,
               int window, float softcap, cudaStream_t stream) {
  if constexpr (D > 128 && kOut == (kDV | kDK)) {  // one launch per output
    const int err = launch_dkv<D, kDV>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Hkv, Nq, Nk, scale, causal, window,
                                       softcap, stream);
    if (err != 0) return err;
    return launch_dkv<D, kDK>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv,
                              Nq, Nk, scale, causal, window, softcap, stream);
  } else {
    constexpr int smem = dkv_smem_bytes<D>();
    auto kern = softcap > 0.f ? flash_bwd_dkv_kernel<D, true, kOut>
                              : flash_bwd_dkv_kernel<D, false, kOut>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((Nk + kBK - 1) / kBK, B * Hkv);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H, Hkv, Nq,
        Nk, scale, causal || window > 0, window, softcap);
    return static_cast<int>(cudaGetLastError());
  }
}

bool bad_shape(int B, int H, int Hkv) {
  return Hkv <= 0 || H % Hkv != 0 || B * H > 65535;
}

}  // namespace

// Both entry points return cudaGetLastError() after the launch (0 =
// launched), launch on ``stream``, do not synchronise and allocate nothing.
// ``delta`` is rowsum(dO * O) - dlse, (B, H, Nq) f32, computed by the caller.
// ``window`` > 0 implies causal; ``window`` <= 0 and ``softcap`` <= 0 mean
// none (the forward's options, which produced ``lse``). Head dims 64, 128
// and 256; at 256 the dK/dV entry point launches its kernel twice, once
// for dV and once for dK.

// dq (B, H, Nq, D) bf16.
extern "C" int lc_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int H, int Hkv, int Nq,
                                    int Nk, int D, float scale, int causal,
                                    int window, float softcap, void* stream) {
  if (bad_shape(B, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Nq, Nk,
                           scale, causal, window, softcap, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Nq, Nk,
                            scale, causal, window, softcap, s);
    case 256:
      return launch_dq<256>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Nq, Nk,
                            scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk, dv (B, Hkv, Nk, D) bf16, each summed over the q heads of its group.
extern "C" int lc_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H,
                                     int Hkv, int Nq, int Nk, int D,
                                     float scale, int causal, int window,
                                     float softcap, void* stream) {
  if (bad_shape(B, H, Hkv)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dkv<64, kDV | kDK>(q, k, v, dout, lse, delta, dk, dv, B,
                                       H, Hkv, Nq, Nk, scale, causal, window,
                                       softcap, s);
    case 128:
      return launch_dkv<128, kDV | kDK>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Hkv, Nq, Nk, scale, causal, window,
                                        softcap, s);
    case 256:
      return launch_dkv<256, kDV | kDK>(q, k, v, dout, lse, delta, dk, dv, B,
                                        H, Hkv, Nq, Nk, scale, causal, window,
                                        softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
