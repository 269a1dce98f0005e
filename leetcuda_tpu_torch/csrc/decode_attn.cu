// Decode attention (one query token per sequence) over a contiguous KV
// cache, for Hopper, bf16 in/out, f32 online softmax.
//
// Replaces: leetcuda_tpu/attention/decode.py make_decode_attention
// (_decode_kernel). q (B, H, D); k/v caches (B, Hkv, S_max, D); lengths
// (B,) int32 = valid positions per sequence (the current token's K/V already
// appended). All contiguous.
//
// Bound on an H100 SXM: bytes. At B=8, Hkv=4, D=128 and a mean length of
// 1024 the kernel must read 16.8 MB of K and V: 5 us at 3.35 TB/s; its
// arithmetic (2 FLOP per byte) is negligible.
// Design, simple first: one CTA of 128 threads per (b, kv head) computes
// the whole GQA group of query rows, so each K/V byte is read once for the
// group. The sequential KV grid axis of the TPU kernel becomes a loop over
// 128-key tiles, and only ceil(len / 128) tiles are visited, so the bytes
// follow the length as the clamped index map (decode.py:127-140) makes them
// on the TPU. Thread j of a tile scores key j against the group (its K row
// read as 16-byte vectors); P goes through shared memory and thread d
// accumulates output column d over the tile's valid keys only, reading V
// rows coalesced. Positions at or past the length are never read, so NaN
// padding (a torch.empty cache, the tail of a prompt bucket) cannot reach
// the accumulator (decode.py:100-113 zeroes both sides of P.V instead).
// At B=8, Hkv=4 this is only 32 CTAs on 132 SMs: a split-KV design that
// spreads one sequence over several SMs is later work.
#include "common.cuh"

namespace {

constexpr int kTK = 128;  // keys per tile = threads per CTA
constexpr int kWarps = kTK / 32;

template <int D, int G>
__global__ void __launch_bounds__(kTK)
decode_attn_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ kc,
                   const uint16_t* __restrict__ vc,
                   const int* __restrict__ lengths, uint16_t* __restrict__ o,
                   int Hkv, int S, float scale) {
  static_assert(D % 8 == 0 && D <= kTK, "head dim");
  __shared__ float sq[G][D];
  __shared__ float sp[G][kTK];
  __shared__ float red[G][kWarps];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = Hkv * G;
  const int len = min(lengths[b], S);
  const uint16_t* qb = q + ((size_t)b * H + kvh * G) * D;
  const uint16_t* kb = kc + ((size_t)b * Hkv + kvh) * S * D;
  const uint16_t* vb = vc + ((size_t)b * Hkv + kvh) * S * D;

  for (int i = tid; i < G * D; i += kTK) sq[i / D][i % D] = lc::bf16_to_f32(qb[i]);
  __syncthreads();

  float m[G], l[G], acc[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = lc::kNegInf;
    l[gi] = 0.f;
    acc[gi] = 0.f;
  }

  const int n_tiles = (len + kTK - 1) / kTK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * kTK;
    const int j = j0 + tid;
    const bool valid = j < len;
    float s[G];
#pragma unroll
    for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
    if (valid) {
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)j * D);
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const uint4 w = kr[c];
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float k0 = __uint_as_float(ws[e] << 16);
          const float k1 = __uint_as_float(ws[e] & 0xffff0000u);
#pragma unroll
          for (int gi = 0; gi < G; ++gi)
            s[gi] += sq[gi][c * 8 + 2 * e] * k0 + sq[gi][c * 8 + 2 * e + 1] * k1;
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      s[gi] = valid ? s[gi] * scale : lc::kNegInf;
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
      sp[gi][tid] = p;
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
      const uint16_t* vcol = vb + (size_t)j0 * D + tid;
      for (int jj = 0; jj < nvalid; ++jj) {
        const float vv = lc::bf16_to_f32(vcol[(size_t)jj * D]);
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
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* lengths,
             void* o, int B, int H, int Hkv, int S, float scale,
             cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* lp = static_cast<const int*>(lengths);
  auto* op = static_cast<uint16_t*>(o);
  switch (H / Hkv) {
    case 1: decode_attn_kernel<D, 1><<<grid, kTK, 0, stream>>>(qp, kp, vp, lp, op, Hkv, S, scale); break;
    case 2: decode_attn_kernel<D, 2><<<grid, kTK, 0, stream>>>(qp, kp, vp, lp, op, Hkv, S, scale); break;
    case 4: decode_attn_kernel<D, 4><<<grid, kTK, 0, stream>>>(qp, kp, vp, lp, op, Hkv, S, scale); break;
    case 8: decode_attn_kernel<D, 8><<<grid, kTK, 0, stream>>>(qp, kp, vp, lp, op, Hkv, S, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). GQA group
// sizes 1, 2, 4, 8 and head dims 64, 128 are instantiated. Launches on
// ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_decode_attn_bf16(const void* q, const void* k, const void* v,
                                   const void* lengths, void* o, int B, int H,
                                   int Hkv, int S, int D, float scale,
                                   void* stream) {
  if (B > 65535 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_d<64>(q, k, v, lengths, o, B, H, Hkv, S, scale, s);
    case 128: return launch_d<128>(q, k, v, lengths, o, B, H, Hkv, S, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
