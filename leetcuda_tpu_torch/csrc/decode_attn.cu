// Decode attention (one query token per sequence) for Hopper as one split-KV
// launch: any GQA group, head dim 64, 128, 256 (Gemma 2's) or 576 (MLA's
// latent: kv_lora_rank 512 + qk_rope_head_dim 64), a bf16 or f32 q and
// output, over a contiguous cache or a paged pool, bf16 or quantized (int8 /
// e4m3 with f32 scales), K and V apart or one shared operand.
//
// Replaces: leetcuda_tpu/attention/decode.py make_decode_attention and
// make_decode_attention_quantized (_decode_kernel, quantized=False/True),
// and leetcuda_tpu/attention/paged.py make_paged_attention (_paged_kernel,
// quantized=False/True), shared_kv included (decode.py:172-176): MLA's
// latent cache (B, 1, S, 576) read once as both K and V, q (B, H, 576) with
// the whole of H in one group. The quantized latent path passes an f32 q
// (the absorbed q . W_uk, not rounded) and takes an f32 output
// (models/mla.py).
// q (B, H, D); caches (B, Hkv, S, D) or pools (N, Hkv, page, D) behind a
// (B, P_max) int32 table (key j of row b in cache row (table[b][j / page] *
// Hkv + kvh) * page + j % page, any page size); lengths (B,) int32 = valid
// positions per sequence (the current token's K/V already appended).
// Quantized, the scales fold past the dots as on the TPU (decode.py:81-99):
// scores are (q . k_raw) * scale * ks[j], the denominator l sums p, and
// P . V takes p * vs[j]. ``window`` > 0 attends only len - window .. len - 1
// (decode.py:59-68, paged.py:66-75); ``softcap`` > 0 caps each score after
// the scale fold and before the mask, cap * tanh(s / cap) with tanhf
// (decode.py:86-87), a compile-time flag (kCap: as a run-time branch its
// tanhf in an unrolled loop took the kernel this one replaced from 0.19 to
// 0.31 ms at B=8). ``lse`` (null, or (B, H) f32) also takes each query row's
// log-sum-exp in natural units, m + log(max(l, 1e-30)) (decode.py:123-124),
// over the keys the row attends; a row of length 0 gets -1e30 and a zero
// output, as on the TPU. q's type and the lse are run-time flags.
//
// Bound on an H100 SXM: bytes. At B=8, Hkv=4, D=128 and lengths 1..2000 the
// kernel must read 16.8 MB of K and V: 5 us at 3.35 TB/s; Gemma-2-9B's
// global layer (B=4, 8 KV heads of 256, context to 6000) 124.6 MB, 37 us.
// Its products are 4 FLOP a K/V element pair a query head: far under the
// tensor cores' rate (MLA's 128 heads over one latent too).
//
// Design: flash-decoding in one launch.
// - Splits. Each row's band [lo, len), lo = max(len - window, 0) or 0, is
//   cut into splits of ``split`` keys (a constant per head dim chosen by the
//   wrapper, attention/decode.py SPLIT_KEYS) counted from lo, so a row's
//   splits depend on its length and window alone and a row gives the same
//   bits alone as in any batch. The grid is (n_split, Hkv x head blocks, B)
//   with n_split = ceil(min(S, window) / split) from the host's capacity:
//   no length is read on the host, so the launch is graph-capturable. A CTA
//   whose split starts past its row's band exits at once.
// - Head blocks. A CTA takes up to 16 query heads of one KV head (the mma's
//   16 rows): groups of 1..16 in one block, MLA's 128 in eight. Rows past
//   the group are never loaded, softmaxed nor written; the tensor cores
//   multiply them as zeros at no cost to a byte-bound kernel.
// - Tiles. 4 warps; 32-key tiles of K and V in a ring of 2-6 stages in
//   shared memory filled by cp.async, 16 bytes a thread, so a warp reads
//   whole contiguous rows and up to five tiles are in flight while one is
//   used (``pick_stages``: the most stages that keep three CTAs an SM,
//   else two, else the most one CTA holds). Keys at or past the split's
//   end are zero-filled (src-size 0, no address computed from them, no
//   table entry past ceil(len / page) read), so NaN padding, table filler,
//   the null page 0 and the e4m3 NaN bytes 0x7F / 0xFF never reach a
//   product. int8 / e4m3 tiles are dequantized from shared memory through
//   cache_policy.cuh into a bf16 tile (exact). With one shared operand the
//   K tile serves as V: the latent is read once. A bf16 q goes to shared
//   memory by cp.async with the first tile.
// - Products. Q.K^T on the tensor cores (mma.sync m16n8k16, f32
//   accumulate), each warp a quarter of the tile's keys; an f32 q is split
//   into bf16 hi + lo (two products, ~16 significant bits). The online
//   softmax runs per tile on 8 threads a row; P is rounded to bf16 for P.V
//   (hi + lo again with an f32 q), each warp a quarter of the head dim,
//   V fragments by ldmatrix.trans.
// - Merge in the same launch. A row of one split writes its output and lse
//   directly. Otherwise each split writes f32 partials (acc, m, l) to a
//   workspace (ws_o (B*H, n_split, D), ws_ml (B*H, n_split, 2)), fences,
//   and counts itself on a device counter of its (row, KV head, head
//   block); the last to arrive merges the splits (their weights over the
//   freed stages; the denominator and each output summed in split order),
//   writes the output and the lse and resets the counter to 0 for the next
//   launch or graph replay. No float atomics: the result is deterministic.
//   Counters are per stream (the wrapper keeps one zeroed buffer a stream).
#include "cache_policy.cuh"
#include "mm_tile.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kHB = 16;        // query heads a CTA: the mma's rows
constexpr int kTK = 32;        // keys a tile
constexpr int kMaxStages = 6;  // tiles in shared memory at most
// Shared memory an SM has, and the most one CTA may take.
constexpr int kSmemPerSM = 228 * 1024, kOnePerSM = 227 * 1024;

// Byte offsets of the dynamic shared memory for ``ns`` stages; a part that
// a launch does not use (the lo halves without an f32 q, V with one shared
// operand, the dequantized tiles of a bf16 cache) takes no room. The
// merge's split weights overlay the stages once the tiles are done.
struct Layout {
  int q_hi, q_lo, s, p_hi, p_lo, small, k_raw, v_raw, scales, k_b, v_b;
  int bytes;
};

__host__ __device__ inline Layout layout(int D, int es, bool scaled,
                                         bool shared, bool q_f32, int ns,
                                         int n_split) {
  const int ldb = 2 * (D + 8), lds = kTK + 8;
  const int raw = ns * kTK * (D * es + 16);
  Layout L{};
  int at = 0;
  L.q_hi = at; at += kHB * ldb;
  L.q_lo = at; at += q_f32 ? kHB * ldb : 0;
  L.s = at; at += kHB * lds * 4;
  L.p_hi = at; at += kHB * lds * 2;
  L.p_lo = at; at += q_f32 ? kHB * lds * 2 : 0;
  L.small = at; at += 256;  // alpha, m, l (16 floats each), the last flag
  L.k_raw = at; at += raw;
  L.v_raw = at; at += shared ? 0 : raw;
  L.scales = at; at += scaled ? ns * 2 * kTK * 4 : 0;
  L.k_b = at; at += scaled ? kTK * ldb : 0;
  L.v_b = at; at += (scaled && !shared) ? kTK * ldb : 0;
  const int merge_end = L.k_raw + (n_split > 1 ? kHB * n_split * 8 : 0);
  L.bytes = at > merge_end ? at : merge_end;
  return L;
}

// Stages a launch takes: the most (up to kMaxStages, at least three) that
// keep three CTAs an SM, else two, else the most (at least two) that fit
// one CTA; 0: none fits. Timed in turn on an H100, three CTAs an SM with
// fewer stages beat two with more at head dim 128 (Gemma-2-27B's decode
// shapes most) and read the same at 256 and 576 (PERF.md rows 3-5).
inline int pick_stages(int D, int es, bool scaled, bool shared, bool q_f32,
                       int n_split) {
  for (int per = 3; per >= 1; --per) {
    // each CTA also holds 1 KB of the SM's shared memory for the system
    const int cap = per == 1 ? kOnePerSM : kSmemPerSM / per - 1024;
    for (int ns = kMaxStages; ns >= (per == 1 ? 2 : 3); --ns)
      if (layout(D, es, scaled, shared, q_f32, ns, n_split).bytes <= cap)
        return ns;
  }
  return 0;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// Wait until at most ``n`` (0..kMaxStages - 2) groups are pending.
__device__ __forceinline__ void cp_wait_dyn(int n) {
  switch (n) {
    case 0: lc::cp_wait<0>(); break;
    case 1: lc::cp_wait<1>(); break;
    case 2: lc::cp_wait<2>(); break;
    case 3: lc::cp_wait<3>(); break;
    default: lc::cp_wait<4>(); break;
  }
}

// 16 quantized values (one 16-byte vector) as bf16 (exact) into ``dst``.
template <class C>
__device__ __forceinline__ void dequant(uint16_t* dst, uint4 w) {
  float f[C::kVec];
  C::vec(w, f);
  uint32_t p[C::kVec / 2];
#pragma unroll
  for (int e = 0; e < C::kVec / 2; ++e)
    p[e] = lc::pack_bf16x2(f[2 * e], f[2 * e + 1]);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int e = 0; e < C::kVec / 8; ++e)
    d[e] = make_uint4(p[4 * e], p[4 * e + 1], p[4 * e + 2], p[4 * e + 3]);
}

// S is the capacity in positions of one sequence: S_max of a contiguous
// cache, P_max * page of a paged one (then ``table`` and ``page`` are set).
// G is the GQA group (H / Hkv); gridDim.y = Hkv * ceil(G / kHB); ``ns``
// the stages (2..kMaxStages).
template <class C, int D, bool kPaged, bool kCap>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const void* __restrict__ q, const typename C::T* kc,
                   const typename C::T* vc, const float* k_scale,
                   const float* v_scale, const int* __restrict__ table,
                   const int* __restrict__ lengths, void* __restrict__ o,
                   float* __restrict__ lse, float* __restrict__ ws_o,
                   float* __restrict__ ws_ml, int* __restrict__ counters,
                   int Hkv, int G, int S, int page, int q_f32, int split,
                   int n_split, int ns, float scale, int window,
                   float softcap) {
  using T = typename C::T;
  constexpr int TK = kTK, LDB = D + 8, LDS = TK + 8;
  constexpr int ES = sizeof(T), RAW = D * ES + 16, CH = D * ES / 16;
  constexpr int KW = TK / 4;              // keys a warp scores (one n8 tile)
  constexpr int DW = D / 4, NTO = DW / 8;  // columns a warp owns, n8 tiles
  constexpr int KP = TK / 8;              // keys a softmax thread takes
  static_assert(D % 16 == 0 && NTO % 2 == 0 && CH * 16 == D * ES &&
                KW == 8, "dims");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coords
  const int sr = tid >> 3, part = tid & 7;         // softmax row and part
  const int nhb = (G + kHB - 1) / kHB;
  const int kvh = blockIdx.y / nhb, hb = blockIdx.y - kvh * nhb;
  const int b = blockIdx.z, si = blockIdx.x;
  const int len = max(min(lengths[b], S), 0);
  const int lo = window > 0 ? max(len - window, 0) : 0;  // the band's start
  const int n_live = max(1, (len - lo + split - 1) / split);
  if (si >= n_live) return;
  const int g0 = hb * kHB, ng = min(kHB, G - g0);  // the block's heads
  const int jb = lo + si * split, je = min(jb + split, len);
  const int n_tiles = je > jb ? (je - jb + TK - 1) / TK : 0;
  const bool shared_kv = kc == vc;
  // the block's first query row among the (B * H) rows of q, o and lse
  const size_t qrow = ((size_t)b * Hkv + kvh) * G + g0;
  const size_t row0 = ((size_t)b * Hkv + kvh) * S;  // contiguous: row0 + j
  const int* tb = kPaged ? table + (size_t)b * (S / page) : nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L =
      layout(D, ES, C::kScaled, shared_kv, q_f32 != 0, ns, n_split);
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem + L.q_hi);
  uint16_t* sQlo = reinterpret_cast<uint16_t*>(smem + L.q_lo);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  uint16_t* sP = reinterpret_cast<uint16_t*>(smem + L.p_hi);
  uint16_t* sPlo = reinterpret_cast<uint16_t*>(smem + L.p_lo);
  float* sAlpha = reinterpret_cast<float*>(smem + L.small);
  float* sM = sAlpha + kHB;
  float* sL = sAlpha + 2 * kHB;
  int* sLast = reinterpret_cast<int*>(sAlpha + 3 * kHB);
  unsigned char* kraw = smem + L.k_raw;
  unsigned char* vraw = shared_kv ? kraw : smem + L.v_raw;
  float* sScale = reinterpret_cast<float*>(smem + L.scales);  // [st][k|v][TK]
  uint16_t* kB = reinterpret_cast<uint16_t*>(smem + L.k_b);
  uint16_t* vB = shared_kv ? kB : reinterpret_cast<uint16_t*>(smem + L.v_b);

  // Key j's row among the (rows, D) rows of the cache (and of its scales);
  // only asked for j < je <= len.
  auto cache_row = [&](int j) -> size_t {
    if constexpr (kPaged) {
      const int lp = j / page;  // this key's logical page
      return ((size_t)tb[lp] * Hkv + kvh) * page + (j - lp * page);
    } else {
      return row0 + j;
    }
  };
  // Tile t of the split into stage t % ns: raw rows (and scales),
  // zero-filled at or past je.
  auto load_tile = [&](int t) {
    const int st = t % ns, j0 = jb + t * TK;
    unsigned char* kd = kraw + st * TK * RAW;
    unsigned char* vd = vraw + st * TK * RAW;
#pragma unroll
    for (int i = tid; i < TK * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH, j = j0 + r;
      const bool ok = j < je;
      const size_t off = ok ? cache_row(j) * (D * ES) + c * 16 : 0;
      lc::cp_async16(kd + r * RAW + c * 16,
                     reinterpret_cast<const unsigned char*>(kc) + off,
                     ok ? 16 : 0);
      if (!shared_kv)
        lc::cp_async16(vd + r * RAW + c * 16,
                       reinterpret_cast<const unsigned char*>(vc) + off,
                       ok ? 16 : 0);
    }
    if constexpr (C::kScaled) {
      if (tid < 2 * TK) {
        const int r = tid % TK, which = tid / TK, j = j0 + r;
        const bool ok = j < je;
        const float* src = which ? v_scale : k_scale;
        cp_async4(sScale + (st * 2 + which) * TK + r,
                  ok ? src + cache_row(j) : src, ok ? 4 : 0);
      }
    }
  };

  // q's rows of the block as bf16 (an f32 q: hi and lo halves), zero rows
  // past the group: a bf16 q by cp.async in the first tile's group
  if (n_tiles > 0) {
    if (q_f32) {
      const float* qf = static_cast<const float*>(q);
#pragma unroll
      for (int i = tid; i < kHB * D / 4; i += kThreads) {
        const int r = i / (D / 4), c = i - r * (D / 4);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < ng)
          x = __ldg(reinterpret_cast<const float4*>(qf + (qrow + r) * D) + c);
        const float xs[4] = {x.x, x.y, x.z, x.w};
        uint32_t hi[2], lw[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float h0 = lc::bf16_to_f32(lc::f32_to_bf16(xs[2 * e]));
          const float h1 = lc::bf16_to_f32(lc::f32_to_bf16(xs[2 * e + 1]));
          hi[e] = lc::pack_bf16x2(h0, h1);
          lw[e] = lc::pack_bf16x2(xs[2 * e] - h0, xs[2 * e + 1] - h1);
        }
        *reinterpret_cast<uint2*>(sQ + r * LDB + 4 * c) =
            make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(sQlo + r * LDB + 4 * c) =
            make_uint2(lw[0], lw[1]);
      }
    } else {
      const uint16_t* qh = static_cast<const uint16_t*>(q);
      for (int i = tid; i < kHB * D / 8; i += kThreads) {
        const int r = i / (D / 8), c = i - r * (D / 8);
        const bool ok = r < ng;
        lc::cp_async16(sQ + r * LDB + 8 * c,
                       ok ? qh + (qrow + r) * D + 8 * c : qh, ok ? 16 : 0);
      }
    }
  }
  // the first ns - 1 tiles in flight, one commit group each (Q in the first)
  for (int t = 0; t < ns - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    lc::cp_commit();
  }

  float m_run = lc::kNegInf, l_run = 0.f;  // softmax row sr's state
  float oacc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_wait_dyn(ns - 2);
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + ns - 1 < n_tiles) load_tile(t + ns - 1);
    lc::cp_commit();
    const int st = t % ns, j0 = jb + t * TK;
    const float* ksc = sScale + st * 2 * TK;
    const float* vsc = ksc + TK;
    const uint16_t* Kt;
    const uint16_t* Vt;
    if constexpr (C::kScaled) {
      const unsigned char* kr = kraw + st * TK * RAW;
      const unsigned char* vr = vraw + st * TK * RAW;
      constexpr int CV = D / C::kVec;
#pragma unroll
      for (int i = tid; i < TK * CV; i += kThreads) {
        const int r = i / CV, c = i - r * CV;
        dequant<C>(kB + r * LDB + c * C::kVec,
                   *reinterpret_cast<const uint4*>(kr + r * RAW + c * 16));
        if (!shared_kv)
          dequant<C>(vB + r * LDB + c * C::kVec,
                     *reinterpret_cast<const uint4*>(vr + r * RAW + c * 16));
      }
      __syncthreads();
      Kt = kB;
      Vt = vB;
    } else {
      Kt = reinterpret_cast<const uint16_t*>(kraw + st * TK * RAW);
      Vt = reinterpret_cast<const uint16_t*>(vraw + st * TK * RAW);
    }

    // scores: warp w takes keys [w * KW, (w + 1) * KW) of the tile
    float sacc[4] = {0.f, 0.f, 0.f, 0.f};
    const uint16_t* kp0 = Kt + (warp * KW + g) * LDB + 2 * t4;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      lc::lds_a(a, sQ + g * LDB + kk * 16 + 2 * t4, LDB);
      const uint32_t bb[2] = {lc::lds32(kp0 + kk * 16),
                              lc::lds32(kp0 + kk * 16 + 8)};
      lc::mma_bf16_16816(sacc, a, bb);
      if (q_f32) {
        lc::lds_a(a, sQlo + g * LDB + kk * 16 + 2 * t4, LDB);
        lc::mma_bf16_16816(sacc, a, bb);
      }
    }
    {
      const int key = warp * KW + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = sacc[2 * h] * scale, x1 = sacc[2 * h + 1] * scale;
        if constexpr (C::kScaled) {
          x0 *= ksc[key];
          x1 *= ksc[key + 1];
        }
        if constexpr (kCap) {
          x0 = softcap * tanhf(x0 / softcap);
          x1 = softcap * tanhf(x1 / softcap);
        }
        *reinterpret_cast<float2*>(sS + (g + 8 * h) * LDS + key) =
            make_float2(j0 + key < je ? x0 : lc::kNegInf,
                        j0 + key + 1 < je ? x1 : lc::kNegInf);
      }
    }
    __syncthreads();

    // online softmax: 8 threads a row, KP keys each
    {
      const bool row_ok = sr < ng;
      float sv[KP];
      float tmax = lc::kNegInf;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int key = part + 8 * i;
        sv[i] = (row_ok && j0 + key < je) ? sS[sr * LDS + key] : lc::kNegInf;
        tmax = fmaxf(tmax, sv[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run, tmax);
      const float alpha = expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        const int key = part + 8 * i;
        const float p =
            (row_ok && j0 + key < je) ? expf(sv[i] - m_new) : 0.f;
        psum += p;
        float pv = p;  // l sums p; P.V takes p * vs
        if constexpr (C::kScaled) pv *= vsc[key];
        const uint16_t hi = lc::f32_to_bf16(pv);
        sP[sr * LDS + key] = hi;
        if (q_f32)
          sPlo[sr * LDS + key] = lc::f32_to_bf16(pv - lc::bf16_to_f32(hi));
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_run = alpha * l_run + psum;
      m_run = m_new;
      if (part == 0) sAlpha[sr] = alpha;
    }
    __syncthreads();

    // P.V: warp w owns output columns [w * DW, (w + 1) * DW)
    const float a0 = sAlpha[g], a1 = sAlpha[g + 8];
#pragma unroll
    for (int n = 0; n < NTO; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4], al[4] = {0u, 0u, 0u, 0u};
      lc::lds_a(a, sP + g * LDS + kk * 16 + 2 * t4, LDS);
      if (q_f32) lc::lds_a(al, sPlo + g * LDS + kk * 16 + 2 * t4, LDS);
      // ldmatrix.trans: lanes 0-7 / 8-15 address keys 0-7 / 8-15 of the
      // k step at columns n0, lanes 16-31 the same at n0 + 8
      const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int np = 0; np < NTO / 2; ++np) {
        const int n0 = warp * DW + np * 16 + (lane >> 4) * 8;
        uint32_t r4[4];
        lc::ldsm_x4_trans(r4, Vt + vrow * LDB + n0);
        const uint32_t b0[2] = {r4[0], r4[1]}, b1[2] = {r4[2], r4[3]};
        lc::mma_bf16_16816(oacc[2 * np], a, b0);
        lc::mma_bf16_16816(oacc[2 * np + 1], a, b1);
        if (q_f32) {
          lc::mma_bf16_16816(oacc[2 * np], al, b0);
          lc::mma_bf16_16816(oacc[2 * np + 1], al, b1);
        }
      }
    }
  }
  lc::cp_wait<0>();  // the empty groups past the last tile

  if (part == 0) {
    sM[sr] = m_run;
    sL[sr] = l_run;
  }
  __syncthreads();

  if (n_live == 1) {  // the whole band in one split: write the result
#pragma unroll
    for (int n = 0; n < NTO; ++n) {
      const int col = warp * DW + n * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= ng) continue;
        const float inv = 1.f / fmaxf(sL[r], 1e-30f);
        const float y0 = oacc[n][2 * h] * inv, y1 = oacc[n][2 * h + 1] * inv;
        const size_t at = (qrow + r) * D + col;
        if (q_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(o) + at) =
              make_float2(y0, y1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(o) + at) =
              lc::pack_bf16x2(y0, y1);
      }
    }
    if (lse != nullptr && tid < ng)
      lse[qrow + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
    return;
  }

  // this split's partials, then the arrival count of the block
#pragma unroll
  for (int n = 0; n < NTO; ++n) {
    const int col = warp * DW + n * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < ng)
        *reinterpret_cast<float2*>(ws_o + ((qrow + r) * n_split + si) * D +
                                   col) =
            make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
    }
  }
  if (tid < ng)
    *reinterpret_cast<float2*>(ws_ml + ((qrow + tid) * n_split + si) * 2) =
        make_float2(sM[tid], sL[tid]);
  __threadfence();  // every thread's partials reach L2 before the count
  __syncthreads();
  int* counter = counters + ((size_t)b * Hkv + kvh) * nhb + hb;
  if (tid == 0) {
    const int last = atomicAdd(counter, 1) == n_live - 1;
    if (last) {
      atomicExch(counter, 0);  // zero again for the next launch or replay
      __threadfence();
    }
    *sLast = last;
  }
  __syncthreads();
  if (!*sLast) return;

  // The last split of the block merges all of them: M = max_s m_s (a warp
  // a row), the weights w_s = exp(m_s - M) and w_s l_s into shared memory
  // over the stages, L = sum_s w_s l_s and each output sum_s w_s acc_s, both
  // in split order.
  float* mw = reinterpret_cast<float*>(kraw);   // [kHB][n_live]
  float* mwl = mw + kHB * n_live;               // [kHB][n_live]
  for (int r = warp; r < ng; r += kThreads / 32) {
    const float* ml = ws_ml + (qrow + r) * n_split * 2;
    float M = lc::kNegInf;
    for (int s = lane; s < n_live; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
    M = lc::warp_max(M);
    if (lane == 0) sM[r] = M;
  }
  __syncthreads();
  for (int i = tid; i < ng * n_live; i += kThreads) {
    const int r = i / n_live, s = i - r * n_live;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        ws_ml + ((qrow + r) * n_split + s) * 2));
    const float w = expf(ml.x - sM[r]);
    mw[i] = w;
    mwl[i] = w * ml.y;
  }
  __syncthreads();
  if (tid < ng) {
    float Ls = 0.f;
    for (int s = 0; s < n_live; ++s) Ls += mwl[tid * n_live + s];
    sL[tid] = Ls;
  }
  __syncthreads();
  // output columns in fours: a thread up to kGrp groups a pass, eight
  // splits' loads in flight
  constexpr int D4 = D / 4, kGrp = 2;
  for (int base = 0; base < ng * D4; base += kGrp * kThreads) {
    float4 acc[kGrp];
#pragma unroll
    for (int k = 0; k < kGrp; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    int rk[kGrp];
    const float4* src[kGrp];
#pragma unroll
    for (int k = 0; k < kGrp; ++k) {
      const int idx = base + tid + k * kThreads;
      rk[k] = idx < ng * D4 ? idx / D4 : -1;
      const int c4 = idx - (idx / D4) * D4;
      src[k] = reinterpret_cast<const float4*>(
                   ws_o + (qrow + (rk[k] < 0 ? 0 : rk[k])) * n_split * D) +
               c4;
    }
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {
#pragma unroll
      for (int k = 0; k < kGrp; ++k) {
        if (rk[k] < 0) continue;
        const float w = mw[rk[k] * n_live + s];
        const float4 x = __ldcg(src[k] + (size_t)s * D4);
        acc[k].x += w * x.x;
        acc[k].y += w * x.y;
        acc[k].z += w * x.z;
        acc[k].w += w * x.w;
      }
    }
#pragma unroll
    for (int k = 0; k < kGrp; ++k) {
      if (rk[k] < 0) continue;
      const int idx = base + tid + k * kThreads, c4 = idx - rk[k] * D4;
      const float inv = 1.f / fmaxf(sL[rk[k]], 1e-30f);
      const size_t at = (qrow + rk[k]) * D + 4 * c4;
      if (q_f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(o) + at) =
            make_float4(acc[k].x * inv, acc[k].y * inv, acc[k].z * inv,
                        acc[k].w * inv);
      } else {
        *reinterpret_cast<uint2*>(static_cast<uint16_t*>(o) + at) =
            make_uint2(lc::pack_bf16x2(acc[k].x * inv, acc[k].y * inv),
                       lc::pack_bf16x2(acc[k].z * inv, acc[k].w * inv));
      }
    }
  }
  if (lse != nullptr && tid < ng)
    lse[qrow + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *lengths;
  void *o, *lse, *ws, *counters;
  int B, H, Hkv, S, page, D, q_f32, split, n_split;
  float scale;
  int window;
  float softcap;
};

template <class C, int D, bool kPaged, bool kCap>
int launch_k(const Args& a, cudaStream_t stream) {
  using T = typename C::T;
  auto kern = decode_attn_kernel<C, D, kPaged, kCap>;
  static unsigned long long attr_devices = 0;
  cudaError_t e = lc::smem_limit_per_device(kern, kOnePerSM, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool shared = a.k == a.v;
  const int ns = pick_stages(D, sizeof(T), C::kScaled, shared, a.q_f32 != 0,
                             a.n_split);
  if (ns == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout(D, sizeof(T), C::kScaled, shared, a.q_f32 != 0,
                           ns, a.n_split).bytes;
  const int G = a.H / a.Hkv, nhb = (G + kHB - 1) / kHB;
  const dim3 grid(a.n_split, a.Hkv * nhb, a.B);
  float* ws = static_cast<float*>(a.ws);
  float* ws_ml = ws ? ws + (size_t)a.B * a.H * a.n_split * D : nullptr;
  kern<<<grid, kThreads, bytes, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.table), static_cast<const int*>(a.lengths),
      a.o, static_cast<float*>(a.lse), ws, ws_ml,
      static_cast<int*>(a.counters), a.Hkv, G, a.S, a.page > 0 ? a.page : 1,
      a.q_f32, a.split, a.n_split, ns, a.scale, a.window, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <class C, int D>
int by_layout(const Args& a, cudaStream_t s) {
  const bool cap = a.softcap > 0.f;
  if (a.page > 0)
    return cap ? launch_k<C, D, true, true>(a, s)
               : launch_k<C, D, true, false>(a, s);
  return cap ? launch_k<C, D, false, true>(a, s)
             : launch_k<C, D, false, false>(a, s);
}

template <class C>
int by_dim(const Args& a, cudaStream_t s) {
  switch (a.D) {
    case 64: return by_layout<C, 64>(a, s);
    case 128: return by_layout<C, 128>(a, s);
    case 256: return by_layout<C, 256>(a, s);
    case 576: return by_layout<C, 576>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// One entry point for every cache and layout; returns cudaGetLastError()
// after the launch (0 = launched). ``cache``: 0 bf16, 1 int8, 2 e4m3 (the
// quantized ones with f32 k_scale / v_scale (B, Hkv, S) or scale pools
// (N, Hkv, page)). ``page`` = 0: contiguous caches (B, Hkv, S, D) and
// ``table`` unused; ``page`` > 0: pools (N, Hkv, page, D), ``table`` (B,
// S / page) int32 and S = P_max * page (the pools must hold fewer than 2^32
// rows). ``q_f32``: q and out are f32 (else bf16). Head dims 64, 128, 256
// and 576; any group H / Hkv; B up to 65535 and Hkv * ceil(G / 16) too. k ==
// v (and k_scale == v_scale) is the shared form. ``window`` <= 0 and
// ``softcap`` <= 0 mean none; ``lse`` is null or (B, H) f32. ``split``: keys
// a split, a multiple of 32; ``n_split`` >= ceil(min(S, window) / split)
// the grid's splits (at most 1024: the merge keeps two floats a split and
// a head in shared memory). With n_split > 1, ``ws`` is B * H *
// n_split * (D + 2) f32 of scratch and ``counters`` B * Hkv * ceil(G / 16)
// int32, zero before the launch and zero again after it; with n_split = 1
// both may be null. Launches on ``stream``, does not synchronise, allocates
// nothing.
extern "C" int lc_decode_attn(const void* q, const void* k, const void* v,
                              const void* k_scale, const void* v_scale,
                              const void* table, const void* lengths,
                              void* o, void* lse, void* ws, void* counters,
                              int B, int H, int Hkv, int S, int page, int D,
                              int cache, int q_f32, int split, int n_split,
                              float scale, int window, float softcap,
                              void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H % Hkv != 0 || S <= 0 ||
      (page > 0 && S % page != 0) || page < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nhb = (H / Hkv + kHB - 1) / kHB;
  const int band = window > 0 && window < S ? window : S;
  if ((long long)Hkv * nhb > 65535 || split <= 0 || split % kTK != 0 ||
      n_split <= 0 || n_split > 1024 || (long long)n_split * split < band ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, table, lengths, o, lse, ws,
               counters, B, H, Hkv, S, page, D, q_f32, split, n_split,
               scale, window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache) {
    case 0: return by_dim<lc::CacheBf16>(a, s);
    case 1: return by_dim<lc::CacheInt8>(a, s);
    case 2: return by_dim<lc::CacheE4m3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
