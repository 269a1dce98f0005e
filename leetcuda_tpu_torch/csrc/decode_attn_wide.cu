// Decode attention in head blocks: any GQA group, head dim 64, 128, 256
// (Gemma 2's) or 576 (MLA's latent: kv_lora_rank 512 + qk_rope_head_dim
// 64), a bf16 or f32 q
// and output, over a contiguous cache or a paged pool, bf16 or quantized
// (int8 / e4m3 with f32 scales), K and V apart or one shared operand.
//
// Replaces: leetcuda_tpu/attention/decode.py make_decode_attention and
// make_decode_attention_quantized, and leetcuda_tpu/attention/paged.py
// make_paged_attention (_decode_kernel, _paged_kernel) where the narrow
// kernel (decode_attn.cu: bf16 q, head dim 64 or 128, a group of 1, 2, 4 or
// 8) does not take the call: every head dim 256 call, and above all their
// ``shared_kv`` form, which
// models/mla.py runs: one latent cache (B, 1, S, 576) read as both K and V
// (decode.py:172-176), q (B, H, 576) with the whole of H in one group.
// The quantized latent path passes an f32 q (the absorbed q . W_uk, not
// rounded) and takes an f32 output (models/mla.py:330-347).
// Shapes and semantics are decode_attn.cu's: q (B, H, D); caches (B, Hkv,
// S, D) or pools (N, Hkv, page, D) through a (B, P_max) table; lengths (B,)
// int32; scales fold past the dots; ``window``, ``softcap`` and ``lse`` as
// there. Positions at or past a length, and before the window, are never
// read, neither values nor scales nor table entries.
//
// Bound on an H100 SXM: bytes. MLA at B=8, a mean length of ~1000: 8 x
// 1000 x 576 x 2 B = 9.2 MB of latent (read once for K and V), 2.8 us at
// 3.35 TB/s; int8 / e4m3 half that plus 4 B of scale a position.
// Design, simple first: a CTA of 128 threads per (kv head, row, head
// block); a head block is kGB = 8 query heads of the group, the last one
// masked (its missing heads score with a zero q and write nothing). So a
// group of 128 (DeepSeek-V2/V3) runs 16 CTAs a row and each holds 8 q rows
// in shared memory (18 KB at D = 576) instead of 128 (295 KB); a key tile
// that a second head block reads again comes from L2 (a layer's latent at
// B = 8 and context 2048 is 18.9 MB of the 50 MB L2). The key walk is
// decode_attn.cu's: 128-key tiles, thread j scores key j against the block
// (its K row as 16-byte vectors), P through shared memory; then each thread
// owns output columns tid, tid + 128, ... (ceil(D / 128) of them: D = 576
// is no multiple of 128) and walks the tile's valid keys reading V rows
// coalesced. With one shared operand K and V are the same pointer (and the
// scales too): the tile's second read, for V, finds it in L1 or L2.
// q's type is a run-time flag read only when q is staged and the output
// written, so it costs no instantiation; so is the lse. The cap stays a
// compile-time flag (kCap): its tanhf sits in the unrolled head loop.
// At B = 8 and 16 heads over one latent head this is 16 CTAs on 132 SMs:
// the split-KV work of the narrow kernel (ROADMAP) applies here too.
#include "cache_policy.cuh"

namespace {

constexpr int kTK = 128;  // keys per tile = threads per CTA
constexpr int kWarps = kTK / 32;
constexpr int kGB = 8;    // query heads per CTA

using lc::CacheBf16;
using lc::CacheE4m3;
using lc::CacheInt8;

// S is the capacity in positions of one sequence: S_max of a contiguous
// cache, P_max * page of a paged one (then ``table`` and ``page`` are set).
// G is the GQA group (H / Hkv); gridDim.z = ceil(G / kGB).
template <class C, int D, bool kPaged, bool kCap>
__global__ void __launch_bounds__(kTK)
decode_attn_wide_kernel(const void* __restrict__ q,
                        const typename C::T* __restrict__ kc,
                        const typename C::T* __restrict__ vc,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, void* __restrict__ o,
                        float* __restrict__ lse, int Hkv, int G, int S,
                        int page, int q_f32, float scale, int window,
                        float softcap) {
  static_assert(D % C::kVec == 0, "head dim");
  constexpr int NC = (D + kTK - 1) / kTK;  // output columns a thread owns
  __shared__ float sq[kGB][D];
  __shared__ float sp[kGB][kTK];
  __shared__ float red[kGB][kWarps];
  __shared__ uint32_t srow[kPaged ? kTK : 1];  // cache row of each tile key

  const int kvh = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * kGB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ng = min(kGB, G - g0);  // the block's live heads
  const int len = min(lengths[b], S);
  const int lo = window > 0 ? max(len - window, 0) : 0;  // the band's start
  // the block's first query row among the (B * H) rows of q, o and lse
  const size_t qrow = ((size_t)b * Hkv + kvh) * G + g0;
  // Key j's row among the (rows, D) rows of the cache (and of its scales).
  const size_t row0 = ((size_t)b * Hkv + kvh) * S;  // contiguous: row0 + j
  const int* tb = kPaged ? table + (size_t)b * (S / page) : nullptr;

  for (int i = tid; i < kGB * D; i += kTK) {
    const int gi = i / D;
    float x = 0.f;
    if (gi < ng) {
      const size_t at = qrow * D + i;
      x = q_f32 ? static_cast<const float*>(q)[at]
                : lc::bf16_to_f32(static_cast<const uint16_t*>(q)[at]);
    }
    sq[gi][i % D] = x;
  }
  __syncthreads();

  float m[kGB], l[kGB], acc[kGB][NC];
#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    m[gi] = lc::kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[gi][c] = 0.f;
  }

  const int n_tiles = (len - lo + kTK - 1) / kTK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = lo + tile * kTK;
    const int j = j0 + tid;
    const bool valid = j < len;
    float s[kGB];
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) s[gi] = 0.f;
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
          for (int gi = 0; gi < kGB; ++gi)
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
    for (int gi = 0; gi < kGB; ++gi) {
      float x = s[gi] * scale * ks;
      if constexpr (kCap) x = softcap * tanhf(x / softcap);
      s[gi] = valid ? x : lc::kNegInf;
      const float wm = lc::warp_max(s[gi]);
      if (lane == 0) red[gi][warp] = wm;
    }
    __syncthreads();
    float m_new[kGB];
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      float tm = red[gi][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tm = fmaxf(tm, red[gi][w]);
      m_new[gi] = fmaxf(m[gi], tm);
    }
    __syncthreads();  // every thread has read the maxima
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      const float p = valid ? expf(s[gi] - m_new[gi]) : 0.f;
      sp[gi][tid] = p * vs;  // l sums p; P.V takes p * vs
      const float ws = lc::warp_sum(p);
      if (lane == 0) red[gi][warp] = ws;
    }
    __syncthreads();
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi) {
      float ts = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ts += red[gi][w];
      const float alpha = expf(m[gi] - m_new[gi]);
      l[gi] = alpha * l[gi] + ts;
      m[gi] = m_new[gi];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[gi][c] *= alpha;
    }
    const int nvalid = min(kTK, len - j0);
    for (int jj = 0; jj < nvalid; ++jj) {
      size_t row = row0 + j0 + jj;
      if constexpr (kPaged) row = srow[jj];
      const typename C::T* vrow = vc + row * D;
      float pj[kGB];
#pragma unroll
      for (int gi = 0; gi < kGB; ++gi) pj[gi] = sp[gi][jj];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tid + c * kTK;
        if (col < D) {
          const float vv = C::one(vrow[col]);
#pragma unroll
          for (int gi = 0; gi < kGB; ++gi) acc[gi][c] += pj[gi] * vv;
        }
      }
    }
    __syncthreads();  // sp, red and srow are rewritten by the next tile
  }

#pragma unroll
  for (int gi = 0; gi < kGB; ++gi) {
    if (gi < ng) {
      const float inv = 1.f / fmaxf(l[gi], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tid + c * kTK;
        if (col < D) {
          const size_t at = (qrow + gi) * D + col;
          const float y = acc[gi][c] * inv;
          if (q_f32)
            static_cast<float*>(o)[at] = y;
          else
            static_cast<uint16_t*>(o)[at] = lc::f32_to_bf16(y);
        }
      }
    }
  }
  if (lse != nullptr && tid == 0) {  // m and l are the same in every thread
#pragma unroll
    for (int gi = 0; gi < kGB; ++gi)
      if (gi < ng) lse[qrow + gi] = m[gi] + logf(fmaxf(l[gi], 1e-30f));
  }
}

template <class C, int D, bool kPaged>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* lengths, void* o,
             void* lse, int B, int H, int Hkv, int S, int page, int q_f32,
             float scale, int window, float softcap, cudaStream_t stream) {
  const int G = H / Hkv;
  const dim3 grid(Hkv, B, (G + kGB - 1) / kGB);
  auto kern = softcap > 0.f ? decode_attn_wide_kernel<C, D, kPaged, true>
                            : decode_attn_wide_kernel<C, D, kPaged, false>;
  kern<<<grid, kTK, 0, stream>>>(
      q, static_cast<const typename C::T*>(k),
      static_cast<const typename C::T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lengths), o, static_cast<float*>(lse), Hkv, G,
      S, page, q_f32, scale, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <class C, bool kPaged>
int launch_p(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* lengths, void* o,
             void* lse, int B, int H, int Hkv, int S, int page, int D,
             int q_f32, float scale, int window, float softcap,
             cudaStream_t s) {
  switch (D) {
    case 64: return launch_d<C, 64, kPaged>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, q_f32, scale, window, softcap, s);
    case 128: return launch_d<C, 128, kPaged>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, q_f32, scale, window, softcap, s);
    case 256: return launch_d<C, 256, kPaged>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, q_f32, scale, window, softcap, s);
    case 576: return launch_d<C, 576, kPaged>(q, k, v, ks, vs, table, lengths, o, lse, B, H, Hkv, S, page, q_f32, scale, window, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class C>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* lengths, void* o,
           void* lse, int B, int H, int Hkv, int S, int page, int D,
           int q_f32, float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page > 0)
    return launch_p<C, true>(q, k, v, ks, vs, table, lengths, o, lse, B, H,
                             Hkv, S, page, D, q_f32, scale, window, softcap,
                             s);
  return launch_p<C, false>(q, k, v, ks, vs, nullptr, lengths, o, lse, B, H,
                            Hkv, S, 1, D, q_f32, scale, window, softcap, s);
}

}  // namespace

// One entry point for every cache and layout; returns cudaGetLastError()
// after the launch (0 = launched). ``cache``: 0 bf16, 1 int8, 2 e4m3 (the
// quantized ones with f32 k_scale / v_scale (B, Hkv, S) or scale pools
// (N, Hkv, page)). ``page`` = 0: contiguous caches (B, Hkv, S, D) and
// ``table`` unused; ``page`` > 0: pools (N, Hkv, page, D), ``table`` (B,
// S / page) int32 and S = P_max * page (the pools must hold fewer than 2^32
// rows). ``q_f32``: q and out are f32 (else bf16). Head dims 64, 128, 256
// and 576; any group H / Hkv (H % Hkv == 0); B and Hkv up to 65535. k == v (and
// k_scale == v_scale) is the shared form. ``window`` <= 0 and ``softcap``
// <= 0 mean none; ``lse`` is null or (B, H) f32. Launches on ``stream``,
// does not synchronise, allocates nothing.
extern "C" int lc_decode_attn_wide(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* table,
                                   const void* lengths, void* o, void* lse,
                                   int B, int H, int Hkv, int S, int page,
                                   int D, int cache, int q_f32, float scale,
                                   int window, float softcap, void* stream) {
  if (B > 65535 || Hkv > 65535 || Hkv <= 0 || H % Hkv != 0 || S <= 0 ||
      (page > 0 && S % page != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (cache) {
    case 0: return launch<CacheBf16>(q, k, v, nullptr, nullptr, table, lengths, o, lse, B, H, Hkv, S, page, D, q_f32, scale, window, softcap, stream);
    case 1: return launch<CacheInt8>(q, k, v, k_scale, v_scale, table, lengths, o, lse, B, H, Hkv, S, page, D, q_f32, scale, window, softcap, stream);
    case 2: return launch<CacheE4m3>(q, k, v, k_scale, v_scale, table, lengths, o, lse, B, H, Hkv, S, page, D, q_f32, scale, window, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
