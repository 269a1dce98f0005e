// Chunk attention (T query tokens per sequence against the KV cache) for
// Hopper, route A: split-KV, the route of speculative verify (few rows per KV
// head). Route B, the TMA + wgmma tiles of chunked prefill and admission, is
// csrc/chunk_tma.cu; attention/chunk.py ``chunk_plan`` picks the route from
// shapes alone.
//
// Replaces: leetcuda_tpu/attention/chunk.py make_chunk_attention and
// make_paged_chunk_attention (both over _chunk_kernel, quantized=False/True).
// q, o (B, H, T, D); row t of sequence b sits at position base[b] + t and
// attends columns < base[b] + t + 1 (the whole prefix, causal inside the
// chunk), with a window also >= base[b] + t + 1 - window. base (B,) int32
// EXCLUDES the chunk, whose own K/V are already in the cache; base + T is
// clamped to the capacity S. Caches (B, Hkv, S, D) with scales (B, Hkv, S),
// or pools (N, Hkv, page, D) with scale pools (N, Hkv, page) behind
// page_table (B, S / page) int32, any page size. Quantized, the scales fold
// past both dots as on the TPU (chunk.py:93-95, 105-108): scores are (q .
// k_raw) * scale * ks[j], the denominator sums p, and P . V takes p * vs[j].
// ``softcap`` > 0 caps each score after that fold and before the mask, cap *
// tanh(s / cap) with tanhf (chunk.py:96-97), a compile-time flag. ``lse``
// (null, or (B, H, T) f32) also takes each row's log-sum-exp over the keys
// it attends, in natural units, m + log(max(l, 1e-30)); a row that attends
// no key gets -1e30 and a zero output, as on the TPU.
//
// Bound on an H100 SXM: bytes. At verify (B=8, Hkv=4, D=128, T=4, a mean
// base of 1024) the kernel must read the 16.8 MB of K and V the rows attend
// once: 5 us at 3.35 TB/s (quantized 8.5 MB, 2.6 us). Its products are 4
// FLOP a K/V element pair a query row, far under the tensor cores' rate.
//
// Design: csrc/decode_attn.cu's flash-decoding with a chunk's rows.
// - Rows. The G * T query rows of one (sequence, KV head) are contiguous in
//   q, o and the lse (row r = g * T + t). A CTA takes 16 of them (the mma's
//   rows; 16 at ModelConfig's verify, G = 4, T = 4), each with its own
//   limit min(base + t + 1, S) and window floor base + t + 1 - window.
// - Splits. The sequence's band [lo, end), lo = max(base + 1 - window, 0)
//   (row 0's floor; 0 without a window) and end = min(base + T, S), is cut
//   into splits of ``split`` keys counted from lo, so a row's splits depend
//   on its own sequence alone and a row gives the same bits alone as in any
//   batch. The grid is (n_split, Hkv x row blocks, B), n_split from the
//   capacity and the window on the host (no length read there: the launch
//   is graph-capturable); a CTA whose split starts past its band exits.
// - Tiles. 4 warps; 32-key tiles of K and V in a ring of 2-6 stages in
//   shared memory filled by cp.async, 16 bytes a thread, up to five tiles in
//   flight while one is used (``pick_stages``). Keys at or past the split's
//   end are zero-filled (src-size 0, no address computed from them, no
//   table entry past ceil(end / page) read), so a torch.empty tail, a
//   page's tail, the null page 0, table filler and the e4m3 NaN bytes 0x7F /
//   0xFF never reach a product. int8 / e4m3 tiles are dequantized from
//   shared memory through cache_policy.cuh into a bf16 tile (exact).
// - Products. Q.K^T on the tensor cores (mma.sync m16n8k16, f32
//   accumulate), each warp a quarter of the tile's keys; the scores are
//   masked per row (split end, the row's limit and floor); the online
//   softmax runs per tile on 8 threads a row; P is rounded to bf16 for P.V,
//   each warp a quarter of the head dim, V fragments by ldmatrix.trans.
// - Merge in the same launch. A row block of one split writes its output
//   and lse directly. Otherwise each split writes f32 partials (acc, m, l)
//   to a workspace, fences, and counts itself on a device counter of its
//   (sequence, KV head, row block); the last to arrive merges the splits in
//   split order, writes the output and the lse and resets the counter to 0
//   for the next launch or graph replay. No float atomics: the result is
//   deterministic. The wrapper keeps the workspace and the counters per
//   stream (gemm/quant.py ``_split_scratch``).
// The tile, row block and stage bound are ``lc_chunk_plan``'s; the macro
// LC_CHUNK_SPLIT_STAGES caps the stages for bench/attn_bench.py --chunk.
#include "cache_policy.cuh"
#include "mm_tile.cuh"

#ifndef LC_CHUNK_SPLIT_STAGES
#define LC_CHUNK_SPLIT_STAGES 6  // tiles in shared memory at most
#endif

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kHB = 16;        // query rows a CTA: the mma's rows
constexpr int kTK = 32;        // keys a tile
constexpr int kMaxStages = LC_CHUNK_SPLIT_STAGES;
constexpr int kMaxSplits = 1024;  // the merge's weights in shared memory
static_assert(kMaxStages >= 2 && kMaxStages <= 6, "stages");
// Shared memory an SM has, and the most one CTA may take.
constexpr int kSmemPerSM = 228 * 1024, kOnePerSM = 227 * 1024;

// Byte offsets of the dynamic shared memory for ``ns`` stages; the
// dequantized tiles take no room with a bf16 cache. The merge's split
// weights overlay the stages once the tiles are done.
struct Layout {
  int q, s, p, small, k_raw, v_raw, scales, k_b, v_b;
  int bytes;
};

__host__ __device__ inline Layout layout(int D, int es, bool scaled, int ns,
                                         int n_split) {
  const int ldb = 2 * (D + 8), lds = kTK + 8;
  const int raw = ns * kTK * (D * es + 16);
  Layout L{};
  int at = 0;
  L.q = at; at += kHB * ldb;
  L.s = at; at += kHB * lds * 4;
  L.p = at; at += kHB * lds * 2;
  L.small = at; at += 256;  // alpha, m, l (16 floats each), the last flag
  L.k_raw = at; at += raw;
  L.v_raw = at; at += raw;
  L.scales = at; at += scaled ? ns * 2 * kTK * 4 : 0;
  L.k_b = at; at += scaled ? kTK * ldb : 0;
  L.v_b = at; at += scaled ? kTK * ldb : 0;
  const int merge_end = L.k_raw + (n_split > 1 ? kHB * n_split * 8 : 0);
  L.bytes = at > merge_end ? at : merge_end;
  return L;
}

// Stages a launch takes: the most (up to kMaxStages, at least three) that
// keep three CTAs an SM, else two, else the most (at least two) that fit
// one CTA; 0: none fits (decode_attn.cu's rule).
inline int pick_stages(int D, int es, bool scaled, int n_split) {
  for (int per = 3; per >= 1; --per) {
    // each CTA also holds 1 KB of the SM's shared memory for the system
    const int cap = per == 1 ? kOnePerSM : kSmemPerSM / per - 1024;
    const int least = per == 1 ? 2 : (kMaxStages < 3 ? kMaxStages : 3);
    for (int ns = kMaxStages; ns >= least; --ns)
      if (layout(D, es, scaled, ns, n_split).bytes <= cap) return ns;
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
// R = G * T query rows a (sequence, KV head); gridDim.y = Hkv * ceil(R /
// kHB); ``ns`` the stages (2..kMaxStages).
template <class C, int D, bool kPaged, bool kCap>
__global__ void __launch_bounds__(kThreads)
chunk_split_kernel(const uint16_t* __restrict__ q, const typename C::T* kc,
                   const typename C::T* vc, const float* k_scale,
                   const float* v_scale, const int* __restrict__ table,
                   const int* __restrict__ base_lengths,
                   uint16_t* __restrict__ o, float* __restrict__ lse,
                   float* __restrict__ ws_o, float* __restrict__ ws_ml,
                   int* __restrict__ counters, int Hkv, int R, int T, int S,
                   int page, int split, int n_split, int ns, float scale,
                   int window, float softcap) {
  using T_ = typename C::T;
  constexpr int TK = kTK, LDB = D + 8, LDS = TK + 8;
  constexpr int ES = sizeof(T_), RAW = D * ES + 16, CH = D * ES / 16;
  constexpr int KW = TK / 4;               // keys a warp scores (one n8 tile)
  constexpr int DW = D / 4, NTO = DW / 8;  // columns a warp owns, n8 tiles
  constexpr int KP = TK / 8;               // keys a softmax thread takes
  static_assert(D % 16 == 0 && NTO % 2 == 0 && CH * 16 == D * ES &&
                KW == 8, "dims");

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment coords
  const int sr = tid >> 3, part = tid & 7;         // softmax row and part
  const int nhb = (R + kHB - 1) / kHB;
  const int kvh = blockIdx.y / nhb, hb = blockIdx.y - kvh * nhb;
  const int b = blockIdx.z, si = blockIdx.x;
  const int base = min(max(base_lengths[b], 0), S);
  const int end = min(base + T, S);  // the band's end: the largest limit
  // the band's start: row 0's window floor, the smallest
  const int lo = window > 0 ? max(base + 1 - window, 0) : 0;
  const int n_live = max(1, (end - lo + split - 1) / split);
  if (si >= n_live) return;
  const int r0 = hb * kHB, nr = min(kHB, R - r0);  // the block's rows
  const int jb = lo + si * split, je = min(jb + split, end);
  const int n_tiles = je > jb ? (je - jb + TK - 1) / TK : 0;
  // the block's first row among the (B * H * T) rows of q, o and lse
  const size_t qrow = ((size_t)b * Hkv + kvh) * R + r0;
  const size_t row0 = ((size_t)b * Hkv + kvh) * S;  // contiguous: row0 + j
  const int* tb = kPaged ? table + (size_t)b * (S / page) : nullptr;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(D, ES, C::kScaled, ns, n_split);
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem + L.q);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  uint16_t* sP = reinterpret_cast<uint16_t*>(smem + L.p);
  float* sAlpha = reinterpret_cast<float*>(smem + L.small);
  float* sM = sAlpha + kHB;
  float* sL = sAlpha + 2 * kHB;
  int* sLast = reinterpret_cast<int*>(sAlpha + 3 * kHB);
  unsigned char* kraw = smem + L.k_raw;
  unsigned char* vraw = smem + L.v_raw;
  float* sScale = reinterpret_cast<float*>(smem + L.scales);  // [st][k|v][TK]
  uint16_t* kB = reinterpret_cast<uint16_t*>(smem + L.k_b);
  uint16_t* vB = reinterpret_cast<uint16_t*>(smem + L.v_b);

  // Key j's row among the (rows, D) rows of the cache (and of its scales);
  // only asked for j < je <= end.
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

  // the block's q rows by cp.async in the first tile's group, zero rows
  // past R
  if (n_tiles > 0) {
    for (int i = tid; i < kHB * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = i - r * (D / 8);
      const bool ok = r < nr;
      lc::cp_async16(sQ + r * LDB + 8 * c, ok ? q + (qrow + r) * D + 8 * c : q,
                     ok ? 16 : 0);
    }
  }
  // the first ns - 1 tiles in flight, one commit group each (Q in the first)
  for (int t = 0; t < ns - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    lc::cp_commit();
  }

  // the limits of the score rows this thread writes (g and g + 8 of the
  // block): keys [flo, lim) and below the split's end; a row past R none
  int lim[2], flo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h, t = r % T;
    lim[h] = r < R ? min(base + t + 1, je) : 0;
    flo[h] = window > 0 ? base + t + 1 - window : 0;
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
        const int j = j0 + key;
        *reinterpret_cast<float2*>(sS + (g + 8 * h) * LDS + key) =
            make_float2(j < lim[h] && j >= flo[h] ? x0 : lc::kNegInf,
                        j + 1 < lim[h] && j + 1 >= flo[h] ? x1 : lc::kNegInf);
      }
    }
    __syncthreads();

    // online softmax: 8 threads a row, KP keys each; a masked score gives
    // p = 0 (also where the row kept nothing yet and m is still -1e30)
    {
      float sv[KP];
      float tmax = lc::kNegInf;
#pragma unroll
      for (int i = 0; i < KP; ++i) {
        sv[i] = sS[sr * LDS + part + 8 * i];
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
        const float p = sv[i] == lc::kNegInf ? 0.f : expf(sv[i] - m_new);
        psum += p;
        float pv = p;  // l sums p; P.V takes p * vs
        if constexpr (C::kScaled) pv *= vsc[key];
        sP[sr * LDS + key] = lc::f32_to_bf16(pv);
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
      uint32_t a[4];
      lc::lds_a(a, sP + g * LDS + kk * 16 + 2 * t4, LDS);
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
        if (r >= nr) continue;
        const float inv = 1.f / fmaxf(sL[r], 1e-30f);
        *reinterpret_cast<uint32_t*>(o + (qrow + r) * D + col) =
            lc::pack_bf16x2(oacc[n][2 * h] * inv, oacc[n][2 * h + 1] * inv);
      }
    }
    if (lse != nullptr && tid < nr)
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
      if (r < nr)
        *reinterpret_cast<float2*>(ws_o + ((qrow + r) * n_split + si) * D +
                                   col) =
            make_float2(oacc[n][2 * h], oacc[n][2 * h + 1]);
    }
  }
  if (tid < nr)
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
  // in split order. A split where a row kept nothing has m_s = -1e30 and
  // weight 0 (or 1 with l_s = 0 where the row kept nothing at all).
  float* mw = reinterpret_cast<float*>(kraw);   // [kHB][n_live]
  float* mwl = mw + kHB * n_live;               // [kHB][n_live]
  for (int r = warp; r < nr; r += kThreads / 32) {
    const float* ml = ws_ml + (qrow + r) * n_split * 2;
    float M = lc::kNegInf;
    for (int s = lane; s < n_live; s += 32) M = fmaxf(M, __ldcg(ml + 2 * s));
    M = lc::warp_max(M);
    if (lane == 0) sM[r] = M;
  }
  __syncthreads();
  for (int i = tid; i < nr * n_live; i += kThreads) {
    const int r = i / n_live, s = i - r * n_live;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(
        ws_ml + ((qrow + r) * n_split + s) * 2));
    const float w = expf(ml.x - sM[r]);
    mw[i] = w;
    mwl[i] = w * ml.y;
  }
  __syncthreads();
  if (tid < nr) {
    float Ls = 0.f;
    for (int s = 0; s < n_live; ++s) Ls += mwl[tid * n_live + s];
    sL[tid] = Ls;
  }
  __syncthreads();
  // output columns in fours: a thread up to kGrp groups a pass, eight
  // splits' loads in flight
  constexpr int D4 = D / 4, kGrp = 2;
  for (int at0 = 0; at0 < nr * D4; at0 += kGrp * kThreads) {
    float4 acc[kGrp];
#pragma unroll
    for (int k = 0; k < kGrp; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    int rk[kGrp];
    const float4* src[kGrp];
#pragma unroll
    for (int k = 0; k < kGrp; ++k) {
      const int idx = at0 + tid + k * kThreads;
      rk[k] = idx < nr * D4 ? idx / D4 : -1;
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
      const int idx = at0 + tid + k * kThreads, c4 = idx - rk[k] * D4;
      const float inv = 1.f / fmaxf(sL[rk[k]], 1e-30f);
      *reinterpret_cast<uint2*>(o + (qrow + rk[k]) * D + 4 * c4) =
          make_uint2(lc::pack_bf16x2(acc[k].x * inv, acc[k].y * inv),
                     lc::pack_bf16x2(acc[k].z * inv, acc[k].w * inv));
    }
  }
  if (lse != nullptr && tid < nr)
    lse[qrow + tid] = sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *base;
  void *o, *lse, *ws, *counters;
  int B, H, Hkv, T, S, page, D, split, n_split;
  float scale;
  int window;
  float softcap;
};

template <class C, int D, bool kPaged, bool kCap>
int launch_k(const Args& a, cudaStream_t stream) {
  using T_ = typename C::T;
  auto kern = chunk_split_kernel<C, D, kPaged, kCap>;
  static unsigned long long attr_devices = 0;
  cudaError_t e = lc::smem_limit_per_device(kern, kOnePerSM, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ns = pick_stages(D, sizeof(T_), C::kScaled, a.n_split);
  if (ns == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = layout(D, sizeof(T_), C::kScaled, ns, a.n_split).bytes;
  const int R = a.H / a.Hkv * a.T, nhb = (R + kHB - 1) / kHB;
  const dim3 grid(a.n_split, a.Hkv * nhb, a.B);
  float* ws = static_cast<float*>(a.ws);
  float* ws_ml = ws ? ws + (size_t)a.B * a.H * a.T * a.n_split * D : nullptr;
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const T_*>(a.k),
      static_cast<const T_*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.table),
      static_cast<const int*>(a.base), static_cast<uint16_t*>(a.o),
      static_cast<float*>(a.lse), ws, ws_ml, static_cast<int*>(a.counters),
      a.Hkv, R, a.T, a.S, a.page > 0 ? a.page : 1, a.split, a.n_split, ns,
      a.scale, a.window, a.softcap);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Route A for every cache and layout; returns cudaGetLastError() after the
// launch (0 = launched). ``cache``: 0 bf16, 1 int8, 2 e4m3 (the quantized
// ones with f32 k_scale / v_scale (B, Hkv, S) or scale pools (N, Hkv,
// page)). ``page`` = 0: contiguous caches (B, Hkv, S, D), ``table`` unused;
// ``page`` > 0: pools (N, Hkv, page, D), ``table`` (B, S / page) int32 and
// S = P_max * page (the pools must hold fewer than 2^32 rows). q and o are
// bf16 (B, H, T, D); head dims 64, 128 and 256; any group H / Hkv and any
// T >= 1. ``window`` <= 0 and ``softcap`` <= 0 mean none; ``lse`` is null or
// (B, H, T) f32. ``split``: keys a split, a multiple of 32; ``n_split`` >=
// ceil(min(S, window + T - 1) / split), the grid's splits, at most 1024.
// With n_split > 1, ``ws`` is B * H * T * n_split * (D + 2) f32 of scratch
// and ``counters`` B * Hkv * ceil(H / Hkv * T / 16) int32, zero before the
// launch and zero again after it; with n_split = 1 both may be null.
// Launches on ``stream``, does not synchronise, allocates nothing.
extern "C" int lc_chunk_split(const void* q, const void* k, const void* v,
                              const void* k_scale, const void* v_scale,
                              const void* table, const void* base_lengths,
                              void* o, void* lse, void* ws, void* counters,
                              int B, int H, int Hkv, int T, int S, int page,
                              int D, int cache, int split, int n_split,
                              float scale, int window, float softcap,
                              void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || H % Hkv != 0 || T <= 0 || S <= 0 ||
      page < 0 || (page > 0 && S % page != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long R = (long long)(H / Hkv) * T;
  const long long band =
      window > 0 && window + T - 1 < S ? window + T - 1 : S;
  if ((long long)Hkv * ((R + kHB - 1) / kHB) > 65535 || split <= 0 ||
      split % kTK != 0 || n_split <= 0 || n_split > kMaxSplits ||
      (long long)n_split * split < band ||
      (n_split > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, k_scale, v_scale, table, base_lengths, o, lse, ws,
               counters, B, H, Hkv, T, S, page, D, split, n_split, scale,
               window, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cache) {
    case 0: return by_dim<lc::CacheBf16>(a, s);
    case 1: return by_dim<lc::CacheInt8>(a, s);
    case 2: return by_dim<lc::CacheE4m3>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Route A's constants as this build has them: info = {rows a CTA, keys a
// tile, most stages, most splits}. Returns 0.
extern "C" int lc_chunk_plan(int* info) {
  const int vals[4] = {kHB, kTK, kMaxStages, kMaxSplits};
  for (int i = 0; i < 4; ++i) info[i] = vals[i];
  return 0;
}
