// The fused decode entry block for Hopper: rms-norm -> projection -> RoPE
// in one kernel, and the same kernel without the RoPE (norm -> matmul).
// x (B, D) bf16, norm weight (D,) bf16, w (D, X) bf16, positions (B,) int32
// -> out (B, X) bf16.
//
// Replaces: leetcuda_tpu/gemm/fused_decode.py make_fused_norm_qkv_rope and
// make_fused_norm_matmul (one body, _fused_kernel, with rope_end = 0 for the
// second). Roundings, in the TPU kernel's order: xhat = x_f32 * rsqrt(mean
// (x^2) + eps) rounded to bf16; times the norm weight in bf16 (with
// ``offset``: (1 + w_f32) rounded to bf16 first); the product accumulates
// in f32 and is rounded to bf16 BEFORE the RoPE; the half-rotation RoPE
// runs in f32 on columns < rope_end, with the angle pos_f32 * powf(theta,
// -i / half) (i the column's index inside its half of the head) through the
// accurate powf / sincosf (positions reach thousands, where the fast
// intrinsics are useless); one more rounding to bf16.
//
// Bound on an H100 SXM: bytes. The weight streams once: D=2048, X=3072 is
// 12.6 MB, 3.8 us at 3.35 TB/s (X=11264: 46.1 MB, 13.8 us); at B <= 16 rows
// the arithmetic (2 B D X FLOP) is negligible.
// Design, simple first. The TPU kernel normalises x once, in its first
// sequential grid step, into a scratch that persists; CTAs run side by
// side, so each CTA normalises its 16 rows itself into shared memory (16 x
// D bf16, 64 KB at D = 2048: cheap beside its weight panel, and its first
// weight loads are already in flight). A CTA of eight warps owns a panel
// of BN = max(128, Dh) columns = whole heads (head dim 64, 128 or 256), so
// the RoPE partner of column c, c +/- Dh/2 inside its head, lies in the
// same CTA and is reached through shared memory (the TPU's lane-roll is a
// Mosaic workaround). The panel is walked in stages of 16384 / BN k rows
// (128 at BN = 128, 64 at BN = 256: a 32 KB stage either way, so the 16
// normalised rows of D = 6144 still fit beside it): the weight
// tile is loaded into registers one stage ahead and interleaved on its way
// into shared memory into bf16x2 words (W[2kp][n], W[2kp+1][n]), exactly
// one B-fragment register of mma.sync m16n8k16; each warp multiplies the
// 16-row A tile (rows past B are zeros) into its 16 columns. Rows beyond
// 16 go to further CTAs along grid.y, which read the panel again (from L2).
// The norm -> matmul kernel and head dims 64 and 128 take BN = 128.
// What holds it back: X / 128 CTAs (24 at X = 3072) on 132 SMs, each
// walking all of D with one stage (32 KB) in flight. Narrower panels need
// the partner exchange across CTAs or split-K: later work, with TMA.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 16;    // rows per CTA: one m16 tile

// The panel of BN columns (whole heads: 128 or 256) and its stages.
template <int BN_>
struct Panel {
  static constexpr int BN = BN_;
  static constexpr int BK = 16384 / BN;  // k rows per stage: 32 KB of w
  // uint32 per sw row; 8 mod 32: no bank conflicts
  static constexpr int LDW = BN + 8;
  static constexpr int WCH = (BK / 2) * (BN / 8) / kThreads;  // chunks a thread
  static constexpr int WN = BN / kWarps;                      // columns a warp
  static constexpr int NT = WN / 8;
  static constexpr int LDO = BN + 4;  // floats per row of the epilogue tile
  static_assert(WCH * kThreads * 16 == BK * BN, "w chunks per thread");
  static_assert((BK / 2) * LDW >= BM * LDO, "the epilogue tile reuses sw");
};

__device__ __forceinline__ void unpack8(uint4 v, float f[8]) {
  const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(ws[e] << 16);
    f[2 * e + 1] = __uint_as_float(ws[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return lc::bf16_to_f32(lc::f32_to_bf16(x));
}

// Chunk i of this thread in a (BK x BN) stage: rows 2 kp and 2 kp + 1,
// columns [8 n8, 8 n8 + 8).
template <class P>
__device__ __forceinline__ void w_chunk(int i, int& kp, int& n8) {
  const int c = threadIdx.x + i * kThreads;
  kp = c / (P::BN / 8);
  n8 = c % (P::BN / 8);
}

// Rows [k0, k0 + BK), columns [n0, n0 + BN) of w (D, X) into registers; D is
// even and X a multiple of 8, so a chunk lies wholly inside or outside.
template <class P>
__device__ __forceinline__ void load_w(uint4 (&r)[P::WCH][2],
                                       const uint16_t* __restrict__ w, int D,
                                       int X, int n0, int k0) {
#pragma unroll
  for (int i = 0; i < P::WCH; ++i) {
    int kp, n8;
    w_chunk<P>(i, kp, n8);
    const int k = k0 + 2 * kp, n = n0 + 8 * n8;
    r[i][0] = r[i][1] = make_uint4(0u, 0u, 0u, 0u);
    if (k < D && n < X) {
      const uint16_t* p = w + (size_t)k * X + n;
      r[i][0] = *reinterpret_cast<const uint4*>(p);
      r[i][1] = *reinterpret_cast<const uint4*>(p + X);
    }
  }
}

// The staged rows, interleaved into bf16x2 words (row 2 kp low, 2 kp + 1
// high), into sw[kp][8 n8 .. 8 n8 + 7].
template <class P>
__device__ __forceinline__ void store_w(uint32_t* sw,
                                        const uint4 (&r)[P::WCH][2]) {
#pragma unroll
  for (int i = 0; i < P::WCH; ++i) {
    int kp, n8;
    w_chunk<P>(i, kp, n8);
    const uint32_t a[4] = {r[i][0].x, r[i][0].y, r[i][0].z, r[i][0].w};
    const uint32_t b[4] = {r[i][1].x, r[i][1].y, r[i][1].z, r[i][1].w};
    uint32_t v[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __byte_perm(a[e], b[e], 0x5410);      // columns 2e
      v[2 * e + 1] = __byte_perm(a[e], b[e], 0x7632);  // columns 2e + 1
    }
    uint4* p = reinterpret_cast<uint4*>(sw + kp * P::LDW + n8 * 8);
    p[0] = make_uint4(v[0], v[1], v[2], v[3]);
    p[1] = make_uint4(v[4], v[5], v[6], v[7]);
  }
}

// Dp = D rounded up to BK; dynamic shared memory: sxn[BM][Dp + 8] bf16, then
// sw[BK / 2][LDW] uint32 (reused as the f32 epilogue tile).
template <bool kRope, class P>
__global__ void __launch_bounds__(kThreads)
fused_norm_matmul_kernel(const uint16_t* __restrict__ x,
                         const uint16_t* __restrict__ nw,
                         const uint16_t* __restrict__ w,
                         const int* __restrict__ pos, uint16_t* __restrict__ o,
                         int B, int D, int X, int Dp, float eps, int offset,
                         int rope_end, int Dh, float theta) {
  constexpr int BN = P::BN, BK = P::BK, LDW = P::LDW, WN = P::WN, NT = P::NT;
  constexpr int LDO = P::LDO;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = Dp + 8;  // (Dp + 8) / 2 = 4 mod 32 words: A reads conflict-free
  uint16_t* sxn = reinterpret_cast<uint16_t*>(smem);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem + (size_t)BM * ldx * 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  uint4 wr[P::WCH][2];
  load_w<P>(wr, w, D, X, n0, 0);  // in flight while the rows are normalised

  // rms-norm of this CTA's rows into sxn; rows past B and columns past D
  // are zeros
  for (int rr = 0; rr < BM / kWarps; ++rr) {
    const int r = warp * (BM / kWarps) + rr, row = m0 + r;
    uint16_t* dst = sxn + r * ldx;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    float rstd = 0.f;
    if (row < B) {
      float ss = 0.f;
      for (int c = lane; c < D / 8; c += 32) {
        float f[8];
        unpack8(xr[c], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += f[e] * f[e];
      }
      ss = lc::warp_sum(ss);
      rstd = rsqrtf(ss / static_cast<float>(D) + eps);
    }
    for (int c = lane; c < Dp / 8; c += 32) {
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (row < B && c < D / 8) {
        float f[8], g[8];
        unpack8(xr[c], f);
        unpack8(reinterpret_cast<const uint4*>(nw)[c], g);
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float y[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float xhat = round_bf16(f[2 * e + h] * rstd);
            const float wn =
                offset ? round_bf16(1.f + g[2 * e + h]) : g[2 * e + h];
            y[h] = xhat * wn;
          }
          v[e] = lc::pack_bf16x2(y[0], y[1]);
        }
        out = make_uint4(v[0], v[1], v[2], v[3]);
      }
      *reinterpret_cast<uint4*>(dst + c * 8) = out;
    }
  }

  float acc[NT][4] = {};
  const int g = lane >> 2, t = lane & 3;
  const int wn0 = warp * WN;
  const int nk = Dp / BK;
  for (int kt = 0; kt < nk; ++kt) {
    store_w<P>(sw, wr);
    __syncthreads();  // sw (and, the first time, sxn) is written
    if (kt + 1 < nk) load_w<P>(wr, w, D, X, n0, (kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint16_t* p = sxn + g * ldx + kt * BK + ks * 16 + 2 * t;
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(p),
          *reinterpret_cast<const uint32_t*>(p + 8 * ldx),
          *reinterpret_cast<const uint32_t*>(p + 8),
          *reinterpret_cast<const uint32_t*>(p + 8 * ldx + 8)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* q = sw + (ks * 8 + t) * LDW + wn0 + nt * 8 + g;
        const uint32_t b[2] = {q[0], q[4 * LDW]};
        lc::mma_bf16_16816(acc[nt], a, b);
      }
    }
    __syncthreads();  // sw is rewritten by the next stage
  }

  // the product, rounded to bf16, as f32 into the epilogue tile
  float* so = reinterpret_cast<float*>(sw);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn0 + nt * 8 + 2 * t;
    so[g * LDO + col] = round_bf16(acc[nt][0]);
    so[g * LDO + col + 1] = round_bf16(acc[nt][1]);
    so[(g + 8) * LDO + col] = round_bf16(acc[nt][2]);
    so[(g + 8) * LDO + col + 1] = round_bf16(acc[nt][3]);
  }
  __syncthreads();

  // Thread -> (head of the panel, index i inside a half): BN / 2 pairs of
  // columns (c1, c1 + half) share one angle per row; kThreads / (BN / 2)
  // row groups (four at BN = 128, two at 256).
  constexpr int kPairs = BN / 2;
  const int half = Dh / 2;
  const int pair = tid % kPairs;
  const int hd = pair / half, i = pair - hd * half;
  const int c1 = hd * Dh + i, c2 = c1 + half;
  const bool roped = kRope && n0 + c1 < rope_end;
  float inv_freq = 0.f;
  if (roped)
    inv_freq = powf(theta, -static_cast<float>(i) / static_cast<float>(half));
  for (int r = tid / kPairs; r < BM; r += kThreads / kPairs) {
    const int row = m0 + r;
    if (row >= B) break;
    float x1 = so[r * LDO + c1], x2 = so[r * LDO + c2];
    if (roped) {
      float sn, cs;
      sincosf(static_cast<float>(pos[row]) * inv_freq, &sn, &cs);
      const float y1 = x1 * cs - x2 * sn, y2 = x2 * cs + x1 * sn;
      x1 = y1;
      x2 = y2;
    }
    uint16_t* orow = o + (size_t)row * X + n0;
    if (n0 + c1 < X) orow[c1] = lc::f32_to_bf16(x1);
    if (n0 + c2 < X) orow[c2] = lc::f32_to_bf16(x2);
  }
}

template <bool kRope, int BN>
int launch(const void* x, const void* nw, const void* w, const void* pos,
           void* o, int B, int D, int X, float eps, int offset, int rope_end,
           int Dh, float theta, void* stream) {
  using P = Panel<BN>;
  constexpr int BK = P::BK;
  if (B <= 0 || D <= 0 || X <= 0 || D % 16 || X % 8 || BN % Dh || Dh % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = (D + BK - 1) / BK * BK;
  const size_t smem =
      (size_t)BM * (Dp + 8) * 2 + (size_t)(BK / 2) * P::LDW * 4;
  const dim3 grid((X + BN - 1) / BN, (B + BM - 1) / BM);
  if (smem > 232448 || grid.y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_norm_matmul_kernel<kRope, P>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(nw),
      static_cast<const uint16_t*>(w), static_cast<const int*>(pos),
      static_cast<uint16_t*>(o), B, D, X, Dp, eps, offset, rope_end, Dh,
      theta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return a CUDA error code (0 = launched). They launch on
// ``stream``, do not synchronise and allocate nothing. They need D % 16 ==
// 0, D <= 6144 (the normalised rows live in shared memory), X % 8 == 0 and
// 16-byte aligned operands.
//
// out (B, X) = rope(rms_norm(x) @ wqkv) with X = (H + 2 Hkv) Dh, RoPE on the
// first (H + Hkv) Dh columns; head_dim 64, 128 (panels of 128 columns) or
// 256 (panels of 256).
extern "C" int lc_fused_norm_qkv_rope(const void* x, const void* norm_w,
                                      const void* wqkv, const void* positions,
                                      void* out, int B, int D, int n_heads,
                                      int n_kv_heads, int head_dim, float eps,
                                      float theta, int rms_offset,
                                      void* stream) {
  const int X = (n_heads + 2 * n_kv_heads) * head_dim;
  const int rope_end = (n_heads + n_kv_heads) * head_dim;
  if (head_dim == 64 || head_dim == 128)
    return launch<true, 128>(x, norm_w, wqkv, positions, out, B, D, X, eps,
                             rms_offset, rope_end, head_dim, theta, stream);
  if (head_dim == 256)
    return launch<true, 256>(x, norm_w, wqkv, positions, out, B, D, X, eps,
                             rms_offset, rope_end, head_dim, theta, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out (B, X) = rms_norm(x) @ w.
extern "C" int lc_fused_norm_matmul(const void* x, const void* norm_w,
                                    const void* w, void* out, int B, int D,
                                    int X, float eps, int rms_offset,
                                    void* stream) {
  return launch<false, 128>(x, norm_w, w, nullptr, out, B, D, X, eps,
                            rms_offset, 0, 128, 0.f, stream);
}
