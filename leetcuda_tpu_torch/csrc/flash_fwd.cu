// Flash-attention forward (FA-2, f32 online softmax) for Hopper, bf16.
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
// Design, simple first: one CTA of four warps per (b*h, 64-row q tile);
// each warp owns 16 query rows and keeps their Q fragments, the running
// max, the denominator and the 16 x D accumulator in registers (f32). The
// sequential KV grid axis of the TPU kernel becomes a loop over 64-key
// tiles staged in padded shared memory; Q.K^T and P.V run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulate), and P is handed
// from the first product to the second in registers. At head dim 256 the
// 16 x D accumulator alone is 128 f32 registers a thread, so that
// instantiation reads the Q fragments from a q tile in shared memory
// instead of holding them, walks 32-key tiles and takes its K, V and q
// tiles (67.6 KB) as dynamic shared memory (common.cuh ``fwd_kv_tile``);
// head dims 64 and 128 keep registers Q and 64-key static tiles. Tiles
// above the diagonal, past lengths[b] and (with a window) wholly left of
// the band are never loaded, so a windowed forward costs O(N * window), as
// the TPU kernel's block skip makes it (flash.py:124-133). The heaviest
// causal q tiles are scheduled first. The cap is taken on the natural-unit
// scaled score, then moved into the log2 domain the softmax runs in: cap *
// log2(e) * tanh(qk * scale / cap), with tanhf (a compile-time flag: the
// uncapped kernel carries no tanh). wgmma, TMA and a multi-stage pipeline
// are later work: this kernel cannot reach the tensor-core peak.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per CTA (16 per warp)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* base, int row,
                                            int nrows, int col, int D) {
  if (row >= nrows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + col);
}

// kLse: write the lse (a separate instantiation, so the inference kernel
// carries no trace of it). kCap: the softcap, likewise.
template <int D, bool kLse, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ lengths,
                 uint16_t* __restrict__ o, float* __restrict__ lse, int H,
                 int Hkv, int Nq, int Nk, float scale_log2, int causal,
                 int window, float scale_over_cap, float cap_log2) {
  constexpr int kBK = lc::fwd_kv_tile(D);
  constexpr bool kQSmem = lc::fwd_dyn_smem_bytes(D, kBQ) > 0;  // Q from smem
  constexpr int LDS = D + 8;      // padded smem row: conflict-free fragments
  constexpr int KSTEPS = D / 16;  // k-steps of Q.K^T
  constexpr int DT = D / 8;       // n-tiles of the output
  constexpr int NT = kBK / 8;     // n-tiles of S
  extern __shared__ __align__(16) uint16_t dsmem[];
  uint16_t *sk, *sv, *sq = nullptr;
  if constexpr (kQSmem) {
    sk = dsmem;
    sv = sk + kBK * LDS;
    sq = sv + kBK * LDS;
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
  const int g = lane >> 2, t = lane & 3;  // mma groupID / thread-in-group
  const int seq_len = lengths ? lengths[b] : Nk;
  const int kv_len = min(seq_len, Nk);

  const uint16_t* qb = q + (size_t)bh * Nq * D;
  const uint16_t* kb = k + (size_t)(b * Hkv + kvh) * Nk * D;
  const uint16_t* vb = v + (size_t)(b * Hkv + kvh) * Nk * D;
  uint16_t* ob = o + (size_t)bh * Nq * D;
  float* lseb = kLse ? lse + (size_t)bh * Nq : nullptr;

  if (lengths && q0 >= seq_len) {
    // the whole tile lies past the valid length: rows are written as zeros
    // and their lse as -1e30 (flash.py:163-178), nothing is computed
    for (int i = threadIdx.x; i < kBQ * (D / 8); i += kThreads) {
      const int row = q0 + i / (D / 8), col = (i % (D / 8)) * 8;
      if (row < Nq)
        *reinterpret_cast<uint4*>(ob + (size_t)row * D + col) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    if (kLse && threadIdx.x < kBQ && q0 + threadIdx.x < Nq)
      lseb[q0 + threadIdx.x] = lc::kNegInf;
    return;
  }

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[kQSmem ? 1 : KSTEPS][4];
  if constexpr (kQSmem) {
    // the q tile into shared memory, rows past Nq as zeros; the first key
    // tile's barrier publishes it
    for (int i = threadIdx.x; i < kBQ * (D / 8); i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < Nq)
        x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + row) * D + col);
      *reinterpret_cast<uint4*>(sq + row * LDS + col) = x;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + t * 2;
      qa[ks][0] = ld_pair(qb, r0, Nq, c, D);
      qa[ks][1] = ld_pair(qb, r0 + 8, Nq, c, D);
      qa[ks][2] = ld_pair(qb, r0, Nq, c + 8, D);
      qa[ks][3] = ld_pair(qb, r0 + 8, Nq, c + 8, D);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {lc::kNegInf, lc::kNegInf};
  float l[2] = {0.f, 0.f};

  // keys >= kv_len are never attended; causal keys past the tile's last row
  // neither, nor keys left of the first row's band (the TPU kernel's block
  // skip, flash.py:124-135)
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q0 + kBQ);
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int kt0 = window > 0 ? max(q0 - window + 1, 0) / kBK : 0;

  for (int kt = kt0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * (D / 8); i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + row < kv_len) {  // rows past the length stay zero: no NaN
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * D + col);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * D + col);
      }
      *reinterpret_cast<uint4*>(sk + row * LDS + col) = kx;
      *reinterpret_cast<uint4*>(sv + row * LDS + col) = vx;
    }
    __syncthreads();

    // S = Q K^T (16 rows x 64 keys per warp), f32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t* a = qa[kQSmem ? 0 : ks];
      uint32_t qf[4];
      if constexpr (kQSmem) {
        lc::lds_a(qf, sq + (warp * 16 + g) * LDS + ks * 16 + t * 2, LDS);
        a = qf;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint16_t* kr = sk + (nt * 8 + g) * LDS + ks * 16 + t * 2;
        uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                          *reinterpret_cast<const uint32_t*>(kr + 8)};
        lc::mma_bf16_16816(s[nt], a, bf);
      }
    }

    // scale (log2 domain; kCap: capped first) and mask
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + (e >= 2 ? 8 : 0);
        const int col = k0 + nt * 8 + t * 2 + (e & 1);
        const bool keep = col < kv_len && (!causal || col <= row) &&
                          (window <= 0 || row - col < window);
        const float x = kCap ? cap_log2 * tanhf(s[nt][e] * scale_over_cap)
                             : s[nt][e] * scale_log2;
        s[nt][e] = keep ? x : lc::kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};

    // P = exp(S - m_new): f32 into the row sums, bf16 into the A fragments
    // of P.V (the C layout of S is the A layout of P, key by key)
    float rs[2] = {0.f, 0.f};
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = s[nt][e] == lc::kNegInf ? 0.f : exp2f(s[nt][e] - mx[e >> 1]);
      rs[0] += p[0] + p[1];
      rs[1] += p[2] + p[3];
      pa[nt / 2][(nt % 2) * 2 + 0] = lc::pack_bf16x2(p[0], p[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = lc::pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
      m[i] = mx[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: B fragments gather two keys of one column from smem
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint16_t* vr = sv + (kk * 16 + t * 2) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const uint16_t* vc = vr + dt * 8;
        uint32_t bf[2] = {
            static_cast<uint32_t>(vc[0]) | (static_cast<uint32_t>(vc[LDS]) << 16),
            static_cast<uint32_t>(vc[8 * LDS]) |
                (static_cast<uint32_t>(vc[9 * LDS]) << 16)};
        lc::mma_bf16_16816(acc[dt], pa[kk], bf);
      }
    }
  }

  // out = acc / max(l, 1e-30); ragged rows past the length are zeros. The
  // lse leaves the log2 domain of m: ln2 * (m + log2(max(l, 1e-30))).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= Nq) continue;
    const bool zero = lengths != nullptr && row >= seq_len;
    const float den = fmaxf(l[i], 1e-30f);
    if (kLse && t == 0)
      lseb[row] = zero ? lc::kNegInf
                       : 0.6931471805599453f * (m[i] + log2f(den));
    uint16_t* orow = ob + (size_t)row * D + t * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float x0 = zero ? 0.f : acc[dt][2 * i] / den;
      const float x1 = zero ? 0.f : acc[dt][2 * i + 1] / den;
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = lc::pack_bf16x2(x0, x1);
    }
  }
}

template <int D, bool kLse>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* o, void* lse, int B, int H, int Hkv, int Nq, int Nk,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr float kLog2e = 1.4426950408889634f;
  dim3 grid((Nq + kBQ - 1) / kBQ, B * H);
  const bool cap = softcap > 0.f;
  const float scale_over_cap = cap ? scale / softcap : 0.f;
  auto kern = cap ? flash_fwd_kernel<D, kLse, true>
                  : flash_fwd_kernel<D, kLse, false>;
  constexpr int smem = lc::fwd_dyn_smem_bytes(D, kBQ);
  if constexpr (smem > 0) {
    static unsigned long long attr_devices[2] = {0, 0};  // per instantiation
    const cudaError_t e =
        lc::smem_limit_per_device(kern, smem, attr_devices[cap]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(lengths),
      static_cast<uint16_t*>(o), static_cast<float*>(lse), H, Hkv, Nq, Nk,
      scale * kLog2e, causal || window > 0, window, scale_over_cap,
      softcap * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Head dims 64, 128 and 256. Returns cudaGetLastError() after the launch
// (0 = launched). ``lengths``
// may be null (plain flash attention), and so may ``lse`` (no LSE output).
// ``window`` > 0 implies causal; ``window`` <= 0 and ``softcap`` <= 0 mean
// none. Launches on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* lengths, void* o, void* lse,
                                 int B, int H, int Hkv, int Nq, int Nk, int D,
                                 float scale, int causal, int window,
                                 float softcap, void* stream) {
  if (B * H > 65535 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool with_lse = lse != nullptr;
  switch (D) {
    case 64:
      return with_lse
          ? launch<64, true>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                             scale, causal, window, softcap, s)
          : launch<64, false>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                              scale, causal, window, softcap, s);
    case 128:
      return with_lse
          ? launch<128, true>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                              scale, causal, window, softcap, s)
          : launch<128, false>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                               scale, causal, window, softcap, s);
    case 256:
      return with_lse
          ? launch<256, true>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                              scale, causal, window, softcap, s)
          : launch<256, false>(q, k, v, lengths, o, lse, B, H, Hkv, Nq, Nk,
                               scale, causal, window, softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
