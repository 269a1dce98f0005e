// Decode attention (one query token per sequence) over a contiguous KV
// cache or a paged pool, for Hopper, bf16 q and output, f32 online softmax;
// the cache is bf16 or quantized (int8 / e4m3 with f32 scales).
//
// Replaces: leetcuda_tpu/attention/decode.py make_decode_attention and
// make_decode_attention_quantized (_decode_kernel, quantized=False/True),
// and leetcuda_tpu/attention/paged.py make_paged_attention (_paged_kernel,
// quantized=False/True).
// q (B, H, D); k/v caches (B, Hkv, S_max, D); lengths (B,) int32 = valid
// positions per sequence (the current token's K/V already appended); for a
// quantized cache, k/v scales (B, Hkv, S_max) f32. All contiguous.
// Quantized, the scales fold past the dots as on the TPU (decode.py:81-99):
// scores are (q . k_raw) * scale * ks[j], the denominator l sums p, and
// P . V takes p * vs[j].
// ``window`` > 0 attends only the last ``window`` positions, len - window ..
// len - 1 (decode.py:59-68, paged.py:66-75): the key walk starts at
// max(0, len - window), so keys, scales and pages before it are never
// read. ``softcap`` > 0 caps each score after the scale fold and before the
// mask, cap * tanh(s / cap) with tanhf (decode.py:86-87: a quantized cache
// caps s * k_scale, not the raw dot). 0 means neither. The cap is a
// compile-time flag (kCap): as a run-time branch, its inlined tanhf in the
// unrolled group loop took the uncapped contiguous kernel from 0.19 to 0.31
// ms on an H100 at B=8, 4 KV heads, lengths up to 2000.
// ``lse`` (null, or (B, H) f32) also takes each query row's log-sum-exp in
// natural units, m + log(max(l, 1e-30)) (decode.py:123-124, paged.py:
// 115-116), over the keys the row attends (only the window's, after the
// cap); a row of length 0 gets -1e30 and a zero output, as on the TPU. It
// is a compile-time flag too (kLse), so the kernels without it are the
// ones they were.
//
// Bound on an H100 SXM: bytes. At B=8, Hkv=4, D=128 and a mean length of
// 1024 the kernel must read 16.8 MB of K and V: 5 us at 3.35 TB/s (an
// int8 / e4m3 cache: 8.4 MB plus 0.13 MB of scales, 2.5 us); its
// arithmetic (2 FLOP per byte) is negligible.
// Design, simple first: one CTA of 128 threads per (b, kv head) computes
// the whole GQA group of query rows, so each K/V byte is read once for the
// group. The sequential KV grid axis of the TPU kernel becomes a loop over
// 128-key tiles, and only ceil(len / 128) tiles are visited, so the bytes
// follow the length as the clamped index map (decode.py:127-140) makes them
// on the TPU. Thread j of a tile scores key j against the group (its K row
// read as 16-byte vectors); P goes through shared memory and thread d
// accumulates output column d over the tile's valid keys only, reading V
// rows coalesced. Positions at or past the length are never read, neither
// their values nor their scales, so NaN padding (a torch.empty cache, the
// tail of a prompt bucket, the e4m3 NaN bytes 0x7F / 0xFF) cannot reach the
// accumulator (decode.py:100-113 zeroes both sides of P.V instead). The
// cache type is a template policy (cache_policy.cuh, shared with the chunk
// kernel): 16-byte K loads hold 8 bf16 or 16 one-byte values; e4m3 decodes
// through the hardware cvt.
// At B=8, Hkv=4 this is only 32 CTAs on 132 SMs: a split-KV design that
// spreads one sequence over several SMs is later work.
//
// Paging is an addressing policy of the same kernel (kPaged). The pools are
// (num_pages, Hkv, page, D), the scale pools (num_pages, Hkv, page), and
// page_table (B, P_max) int32 maps a row's logical page to a physical one:
// key j of row b lives in cache row (table[b][j / page] * Hkv + kvh) * page
// + j % page. Thread j looks its own key's row up for the scores and leaves
// it in shared memory for the V walk, so a tile may span any number of
// pages and every page size works. The bound is the contiguous kernel's
// (the valid K and V bytes) plus the table. The TPU kernel's G pages per
// grid step, its clamped index maps and its VMEM scratch are DMA scheduling
// and have no counterpart. Only pages below ceil(len / page) are looked up
// and only positions below len are read: table filler, the null page 0 and
// the tail of a row's last page may hold anything.
#include "cache_policy.cuh"

namespace {

constexpr int kTK = 128;  // keys per tile = threads per CTA
constexpr int kWarps = kTK / 32;

using lc::CacheBf16;
using lc::CacheE4m3;
using lc::CacheInt8;

// S is the capacity in positions of one sequence: S_max of a contiguous
// cache, P_max * page of a paged one (then ``table`` and ``page`` are set).
template <class C, int D, int G, bool kPaged, bool kCap, bool kLse>
__global__ void __launch_bounds__(kTK)
decode_attn_kernel(const uint16_t* __restrict__ q,
                   const typename C::T* __restrict__ kc,
                   const typename C::T* __restrict__ vc,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ table,
                   const int* __restrict__ lengths, uint16_t* __restrict__ o,
                   float* __restrict__ lse, int Hkv, int S, int page,
                   float scale, int window, float softcap) {
  static_assert(D % C::kVec == 0 && D <= kTK, "head dim");
  __shared__ float sq[G][D];
  __shared__ float sp[G][kTK];
  __shared__ float red[G][kWarps];
  __shared__ uint32_t srow[kPaged ? kTK : 1];  // cache row of each tile key

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * G;
  const int len = min(lengths[b], S);
  const int lo = window > 0 ? max(len - window, 0) : 0;  // the band's start
  const uint16_t* qb = q + ((size_t)b * H + kvh * G) * D;
  // Key j's row among the (rows, D) rows of the cache (and of its scales).
  const size_t row0 = ((size_t)b * Hkv + kvh) * S;  // contiguous: row0 + j
  const int* tb = kPaged ? table + (size_t)b * (S / page) : nullptr;

  for (int i = tid; i < G * D; i += kTK) sq[i / D][i % D] = lc::bf16_to_f32(qb[i]);
  __syncthreads();

  float m[G], l[G], acc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = lc::kNegInf;
    l[gi] = 0.f;
    acc[gi] = 0.f;
  }

  const int n_tiles = (len - lo + kTK - 1) / kTK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = lo + tile * kTK;
    const int j = j0 + tid;
    const bool valid = j < len;
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
    float ks = 1.f, vs = 1.f;  // this key's scales (quantized caches)
    if (valid) {
      size_t row = row0 + j;
      if constexpr (kPaged) {
        const int lp = j / page;  // this key's logical page
        row = ((size_t)tb[lp] * Hkv + kvh) * page + (j - lp * page);
        srow[tid] = static_cast<uint32_t>(row);
      }
      const uint4* kr = reinterpret_cast<const uint4*>(kc + row * D);
#pragma unroll 4
      for (int c = 0; c < D / C::kVec; ++c) {
        float kf[C::kVec];
        C::vec(kr[c], kf);
#pragma unroll
        for (int e = 0; e < C::kVec; e += 2) {
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            s[gi] += sq[gi][c * C::kVec + e] * kf[e] +
                     sq[gi][c * C::kVec + e + 1] * kf[e + 1];
        }
      }
      if constexpr (C::kScaled) {
        ks = k_scale[row];
        vs = v_scale[row];
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float x = s[gi] * scale * ks;
      if constexpr (kCap) x = softcap * tanhf(x / softcap);
      s[gi] = valid ? x : lc::kNegInf;
      const float wm = lc::warp_max(s[gi]);
      if (lane == 0) red[gi][warp] = wm;
    }
    __syncthreads();
    float m_new[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float tm = red[gi][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red[gi][w]);
      m_new[gi] = fmaxf(m[gi], tm);
    }
    __syncthreads();  // every thread has read the maxima
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float p = valid ? expf(s[gi] - m_new[gi]) : 0.f;
      sp[gi][tid] = p * vs;  // l sums p; P.V takes p * vs
      const float ws = lc::warp_sum(p);
      if (lane == 0) red[gi][warp] = ws;
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float ts = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ts += red[gi][w];
      const float alpha = expf(m[gi] - m_new[gi]);
      l[gi] = alpha * l[gi] + ts;
      m[gi] = m_new[gi];
      acc[gi] *= alpha;
    }
    if (tid < D) {
      const int nvalid = min(kTK, len - j0);
      const typename C::T* vcol = vc + tid;
      for (int jj = 0; jj < nvalid; ++jj) {
        size_t row = row0 + j0 + jj;
        if constexpr (kPaged) row = srow[jj];
        const float vv = C::one(vcol[row * D]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) acc[gi] += sp[gi][jj] * vv;
      }
    }
    __syncthreads();  // sp and red are rewritten by the next tile
  }

  if (tid < D) {
    uint16_t* ob = o + ((size_t)b * H + kvh * G) * D + tid;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      ob[(size_t)gi * D] = lc::f32_to_bf16(acc[gi] / fmaxf(l[gi], 1e-30f));
  }
  if constexpr (kLse) {  // m and l are the same in every thread
    if (tid == 0) {
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        lse[(size_t)b * H + kvh * G + gi] =
            m[gi] + logf(fmaxf(l[gi], 1e-30f));
    }
  }
}

template <class C, int D, bool kPaged>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* lengths, void* o,
             void* lse, int B, int H, int Hkv, int S, int page, float scale,
             int window, float softcap, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const typename C::T*>(k);
  const auto* vp = static_cast<const typename C::T*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* tp = static_cast<const int*>(table);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  auto* sp = static_cast<float*>(lse);
  const bool cap = softcap > 0.f;
#define LC_DECODE_LAUNCH(G)                                                 \
  {                                                                         \
    auto kern =                                                             \
        sp ? (cap ? decode_attn_kernel<C, D, G, kPaged, true, true>         \
                  : decode_attn_kernel<C, D, G, kPaged, false, true>)       \
           : (cap ? decode_attn_kernel<C, D, G, kPaged, true, false>        \
                  : decode_attn_kernel<C, D, G, kPaged, false, false>);     \
    kern<<<grid, kTK, 0, stream>>>(qp, kp, vp, ksp, vsp, tp, lp, op, sp,    \
                                   Hkv, S, page, scale, window, softcap);   \
  }
  switch (H / Hkv) {
    case 1: LC_DECODE_LAUNCH(1); break;
    case 2: LC_DECODE_LAUNCH(2); break;
    case 4: LC_DECODE_LAUNCH(4); break;
    case 8: LC_DECODE_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LC_DECODE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ``page`` > 0 selects the paged addressing: k, v (and the scales) are pools,
// ``table`` is (B, S / page) and S = P_max * page.
template <class C>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* o,
           void* lse, int B, int H, int Hkv, int S, int page, int D,
           float scale, int window, float softcap, void* stream) {
  if (B > 65535 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page > 0) {
    switch (D) {
      case 64: return launch_d<C, 64, true>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, scale, window, softcap, s);
      case 128: return launch_d<C, 128, true>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, scale, window, softcap, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 64: return launch_d<C, 64, false>(q, k, v, ks, vs, nullptr, lengths, o, lse, B, H, Hkv, S, 1, scale, window, softcap, s);
    case 128: return launch_d<C, 128, false>(q, k, v, ks, vs, nullptr, lengths, o, lse, B, H, Hkv, S, 1, scale, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 =
// launched). GQA group sizes 1, 2, 4, 8 and head dims 64, 128 are
// instantiated. ``window`` <= 0 and ``softcap`` <= 0 mean none; ``lse``
// is null (no lse) or (B, H) f32. They launch on ``stream``, do not
// synchronise and allocate nothing.
extern "C" int lc_decode_attn_bf16(const void* q, const void* k, const void* v,
                                   const void* lengths, void* o, void* lse,
                                   int B, int H, int Hkv, int S, int D,
                                   float scale, int window, float softcap,
                                   void* stream) {
  return launch<CacheBf16>(q, k, v, nullptr, nullptr, nullptr, lengths, o,
                           lse, B, H, Hkv, S, 0, D, scale, window, softcap,
                           stream);
}

// A quantized cache: ``fp8`` selects e4m3 values (else int8); k_scale and
// v_scale are (B, Hkv, S) f32.
extern "C" int lc_decode_attn_q(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* o, void* lse,
                                int B, int H, int Hkv, int S, int D, int fp8,
                                float scale, int window, float softcap,
                                void* stream) {
  if (fp8)
    return launch<CacheE4m3>(q, k, v, k_scale, v_scale, nullptr, lengths, o,
                             lse, B, H, Hkv, S, 0, D, scale, window, softcap,
                             stream);
  return launch<CacheInt8>(q, k, v, k_scale, v_scale, nullptr, lengths, o,
                           lse, B, H, Hkv, S, 0, D, scale, window, softcap,
                           stream);
}

// Paged pools: k_pages, v_pages (num_pages, Hkv, page, D) bf16; page_table
// (B, P_max) int32; lengths (B,) int32. Any page size >= 1; the pools must
// hold fewer than 2^32 rows (num_pages * Hkv * page).
extern "C" int lc_paged_attn_bf16(const void* q, const void* k_pages,
                                  const void* v_pages, const void* page_table,
                                  const void* lengths, void* o, void* lse,
                                  int B, int H, int Hkv, int P_max, int page,
                                  int D, float scale, int window,
                                  float softcap, void* stream) {
  if (page <= 0 || P_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<CacheBf16>(q, k_pages, v_pages, nullptr, nullptr, page_table,
                           lengths, o, lse, B, H, Hkv, P_max * page, page, D,
                           scale, window, softcap, stream);
}

// Quantized paged pools: int8 or (``fp8``) e4m3 values with f32 scale pools
// (num_pages, Hkv, page).
extern "C" int lc_paged_attn_q(const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scales,
                               const void* v_scales, const void* page_table,
                               const void* lengths, void* o, void* lse,
                               int B, int H, int Hkv, int P_max, int page,
                               int D, int fp8, float scale, int window,
                               float softcap, void* stream) {
  if (page <= 0 || P_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (fp8)
    return launch<CacheE4m3>(q, k_pages, v_pages, k_scales, v_scales,
                             page_table, lengths, o, lse, B, H, Hkv,
                             P_max * page, page, D, scale, window, softcap,
                             stream);
  return launch<CacheInt8>(q, k_pages, v_pages, k_scales, v_scales,
                           page_table, lengths, o, lse, B, H, Hkv,
                           P_max * page, page, D, scale, window, softcap,
                           stream);
}
