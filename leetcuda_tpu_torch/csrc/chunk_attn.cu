// Chunk attention (T query tokens per sequence against the KV cache) for
// Hopper: the kernel of speculative verify, prefix-cached admission and
// chunked prefill. bf16 q and output, f32 online softmax; the cache is
// contiguous or paged, bf16 or quantized (int8 / e4m3 with f32 scales).
//
// Replaces: leetcuda_tpu/attention/chunk.py make_chunk_attention and
// make_paged_chunk_attention (both over _chunk_kernel, quantized=False/True).
// q, o (B, H, T, D); row t of sequence b sits at position base[b] + t and
// attends columns < base[b] + t + 1 (the whole prefix, causal inside the
// chunk), with a window also >= base[b] + t + 1 - window. base (B,) int32
// EXCLUDES the chunk, whose own K/V are already in the cache. Caches
// (B, Hkv, S, D) with scales (B, Hkv, S), or pools (N, Hkv, page, D) with
// scale pools (N, Hkv, page) behind page_table (B, P_max) int32. Quantized,
// the scales fold past both dots as on the TPU (chunk.py:93-95, 105-108):
// scores are (q . k_raw) * scale * ks[j], the denominator sums p, and P . V
// takes p * vs[j]. ``softcap`` > 0 caps each score after that fold and
// before the mask, cap * tanh(s / cap) (chunk.py:96-97), with tanhf on the
// natural-unit score, then moves it into the kernel's log2 domain; the cap
// is a compile-time flag (kCap), so the uncapped kernel carries no tanh.
// ``lse`` (null, or (B, H, T) f32, chunk.py:128-129 and :217-218) also takes
// each query row's log-sum-exp over the keys it attends, in natural units:
// the online softmax runs in the log2 domain, so it is ln2 * (m + log2(max(
// l, 1e-30))), as csrc/flash_fwd.cu writes its lse; a row that attends no
// key (past the capacity, behind its window) keeps m = -1e30 and gets an
// lse of -1e30 and a zero output, as on the TPU. A compile-time flag too
// (kLse): the kernels without it are the ones they were.
//
// Bound on an H100 SXM: two regimes. Verify (T = 2..8): the rows of one KV
// head are G * T = 8..32 and the kernel must read the valid K and V once, as
// decode does: at B=8, Hkv=4, D=128 and a mean base of 1024, 16.8 MB (5 us
// at 3.35 TB/s; 8.5 MB and 2.6 us quantized). Admission (T = 128..1024):
// operations; T=1024 at base 1024 is 12.9 GFLOP, 13 us at the 989 TFLOP/s
// bf16 tensor-core peak.
// Design, simple first, one kernel for both: the flash forward's tile
// (flash_fwd.cu) with the GQA group packed into the row tile. The G * T
// query rows of one (sequence, KV head) are contiguous in q (row r = g * T +
// t), so a CTA of four warps takes 64 of them, 16 per warp, and every K/V
// byte is fetched once for the whole group. The sequential KV grid axis of
// the TPU kernel becomes a loop over 64-key tiles staged in padded shared
// memory as bf16: bf16 caches are copied, int8 and e4m3 values converted
// (exactly) on the way in, their scales kept beside the tile in f32. Q.K^T
// and P.V run on the tensor cores (mma.sync m16n8k16, f32 accumulate); P is
// rounded to bf16 for the second product (quantized: p * vs[j] is), as in
// the flash kernel. A q tile with chunk rows t_lo..t_hi visits key tiles
// below base + t_hi + 1 and, with a window, from base + t_lo + 1 - window:
// tiles outside are never loaded. Each thread fetches a tile's vectors in
// batches of four loads in flight at once (one dependent load at a time took
// twice as long at both shapes). At head dim 256 the tiles change as the
// flash kernel's do (common.cuh ``fwd_kv_tile``): Q fragments from a q
// tile in shared memory, 32-key tiles, and the K, V and q tiles (67.6 KB)
// as dynamic shared memory. Warps whose 16 rows lie past G * T only
// help load: at verify one warp of four computes and 32 CTAs walk up to 32
// tiles each, load then compute, so the kernel is far from its byte bound;
// spreading a sequence's keys over warps and CTAs is later work.
// Positions at or past min(base + T, S) are never read, values or scales:
// a torch.empty cache, the tail of a page, the null page 0, table filler and
// the e4m3 NaN bytes cannot reach the accumulator (chunk.py:109-117 zeroes
// both sides of P.V instead). Positions in [base + t + 1, base + T) hold the
// chunk's own later K/V and are masked for row t with -1e30; the
// denominator is floored at 1e-30. Paging is an addressing policy: key j
// lives in cache row (table[b][j / page] * Hkv + kvh) * page + j % page, any
// page size; the TPU kernel's clamped index maps and VMEM scratch are DMA
// scheduling and have no counterpart.
#include "cache_policy.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per CTA (16 per warp)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* base, int row,
                                            int nrows, int col, int D) {
  if (row >= nrows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * D + col);
}

// One 16-byte vector of cache values as bf16 into a shared-memory row.
template <class C>
__device__ __forceinline__ void stage(uint16_t* dst, uint4 w) {
  if constexpr (!C::kScaled) {
    *reinterpret_cast<uint4*>(dst) = w;
  } else {
    float f[C::kVec];
    C::vec(w, f);
#pragma unroll
    for (int h = 0; h < C::kVec / 8; ++h)
      *reinterpret_cast<uint4*>(dst + 8 * h) = make_uint4(
          lc::pack_bf16x2(f[8 * h], f[8 * h + 1]),
          lc::pack_bf16x2(f[8 * h + 2], f[8 * h + 3]),
          lc::pack_bf16x2(f[8 * h + 4], f[8 * h + 5]),
          lc::pack_bf16x2(f[8 * h + 6], f[8 * h + 7]));
  }
}

// S is the capacity in positions of one sequence: S_max of a contiguous
// cache, P_max * page of a paged one (then ``table`` and ``page`` are set).
template <class C, int D, bool kPaged, bool kCap, bool kLse>
__global__ void __launch_bounds__(kThreads)
chunk_attn_kernel(const uint16_t* __restrict__ q,
                  const typename C::T* __restrict__ kc,
                  const typename C::T* __restrict__ vc,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int* __restrict__ table,
                  const int* __restrict__ base_lengths,
                  uint16_t* __restrict__ o, float* __restrict__ lse, int H,
                  int Hkv, int T, int S,
                  int page, int window, float scale_log2,
                  float scale_over_cap, float cap_log2) {
  constexpr int kBK = lc::fwd_kv_tile(D);
  constexpr bool kQSmem = lc::fwd_dyn_smem_bytes(D, kBQ) > 0;  // Q from smem
  constexpr int LDS = D + 8;       // padded smem row: conflict-free fragments
  constexpr int KSTEPS = D / 16;   // k-steps of Q.K^T
  constexpr int DT = D / 8;        // n-tiles of the output
  constexpr int NT = kBK / 8;      // n-tiles of S
  constexpr int VPR = D / C::kVec; // 16-byte vectors per cache row
  constexpr int kLoads = kBK * VPR / kThreads;  // vectors per thread and tile
  constexpr int kBatch = kLoads < 4 ? kLoads : 4;
  static_assert(kBK * VPR % kThreads == 0 && kLoads % kBatch == 0, "tile");
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
  __shared__ float sks[kBK];       // the tile keys' scales (quantized)
  __shared__ float svs[kBK];
  __shared__ uint32_t srow[kBK];   // the tile keys' cache rows

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int n_rows = G * T;  // query rows of this (sequence, KV head)
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread-in-group
  const int base = min(max(base_lengths[b], 0), S);

  // rows (g, t) of one KV head are contiguous in q and o: row r = g * T + t
  const size_t head0 = ((size_t)b * H + (size_t)kvh * G) * T * D;
  const uint16_t* qb = q + head0;
  uint16_t* ob = o + head0;
  const int* tb = kPaged ? table + (size_t)b * (S / page) : nullptr;

  // the chunk rows t_lo..t_hi of this tile bound the keys it visits
  const int r_last = min(q0 + kBQ, n_rows) - 1;
  int t_lo = 0, t_hi = T - 1;
  if (q0 / T == r_last / T) {
    t_lo = q0 % T;
    t_hi = r_last % T;
  }
  const int kv_end = min(base + t_hi + 1, S);
  const int kv_begin = window > 0 ? max(base + t_lo + 1 - window, 0) : 0;

  const bool warp_live = q0 + warp * 16 < n_rows;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  int limit[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const int lim = base + row % T + 1;  // row t sees columns < base + t + 1
    limit[i] = row < n_rows ? min(lim, S) : 0;
    lo[i] = window > 0 ? lim - window : 0;
  }

  uint32_t qa[kQSmem ? 1 : KSTEPS][4];
  if constexpr (kQSmem) {
    // the q tile into shared memory, rows past n_rows as zeros; the first
    // key tile's barriers publish it
    for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + row < n_rows)
        x = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + row) * D + col);
      *reinterpret_cast<uint4*>(sq + row * LDS + col) = x;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int c = ks * 16 + t4 * 2;
      qa[ks][0] = ld_pair(qb, r0, n_rows, c, D);
      qa[ks][1] = ld_pair(qb, r0 + 8, n_rows, c, D);
      qa[ks][2] = ld_pair(qb, r0, n_rows, c + 8, D);
      qa[ks][3] = ld_pair(qb, r0 + 8, n_rows, c + 8, D);
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m[2] = {lc::kNegInf, lc::kNegInf};
  float l[2] = {0.f, 0.f};

  const int n_tiles = (kv_end + kBK - 1) / kBK;
  for (int kt = kv_begin / kBK; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    if (tid < kBK) {
      // key k0 + tid: its cache row and scales; keys at or past kv_end are
      // not looked up and stage as zeros
      const int col = k0 + tid;
      size_t row = 0;
      float ks = 0.f, vs = 0.f;
      if (col < kv_end) {
        if constexpr (kPaged) {
          const int lp = col / page;
          row = ((size_t)tb[lp] * Hkv + kvh) * page + (col - lp * page);
        } else {
          row = ((size_t)b * Hkv + kvh) * S + col;
        }
        if constexpr (C::kScaled) {
          ks = k_scale[row];
          vs = v_scale[row];
        }
      }
      srow[tid] = static_cast<uint32_t>(row);
      sks[tid] = ks;
      svs[tid] = vs;
    }
    __syncthreads();
    // each thread stages kLoads vectors of K and of V, four at a time: the
    // loads of a batch are all in flight before the first is used
#pragma unroll
    for (int i0 = 0; i0 < kLoads; i0 += kBatch) {
      uint4 kx[kBatch], vx[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = tid + (i0 + j) * kThreads;
        const int kr = i / VPR, c = (i % VPR) * C::kVec;
        kx[j] = vx[j] = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + kr < kv_end) {
          const size_t off = (size_t)srow[kr] * D + c;
          kx[j] = *reinterpret_cast<const uint4*>(kc + off);
          vx[j] = *reinterpret_cast<const uint4*>(vc + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = tid + (i0 + j) * kThreads;
        const int kr = i / VPR, c = (i % VPR) * C::kVec;
        if (k0 + kr < kv_end) {
          stage<C>(sk + kr * LDS + c, kx[j]);
          stage<C>(sv + kr * LDS + c, vx[j]);
        } else {  // zeros, not a decode of zero bytes
#pragma unroll
          for (int h = 0; h < C::kVec / 8; ++h) {
            *reinterpret_cast<uint4*>(sk + kr * LDS + c + 8 * h) = kx[j];
            *reinterpret_cast<uint4*>(sv + kr * LDS + c + 8 * h) = vx[j];
          }
        }
      }
    }
    __syncthreads();
    if (!warp_live) continue;  // warp-uniform: this warp owns no query row

    // S = Q K^T (16 rows x 64 keys per warp), f32
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const uint32_t* a = qa[kQSmem ? 0 : ks];
      uint32_t qf[4];
      if constexpr (kQSmem) {
        lc::lds_a(qf, sq + (warp * 16 + g) * LDS + ks * 16 + t4 * 2, LDS);
        a = qf;
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint16_t* kr = sk + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kr),
                          *reinterpret_cast<const uint32_t*>(kr + 8)};
        lc::mma_bf16_16816(s[nt], a, bf);
      }
    }

    // scale (log2 domain; quantized: times the key's scale; with a cap,
    // capped in natural units first) and mask
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kk = nt * 8 + t4 * 2 + (e & 1);
        const int col = k0 + kk;
        const bool keep = col < limit[i] && col >= lo[i];
        float x;
        if constexpr (kCap) {
          x = s[nt][e] * scale_over_cap;
          if constexpr (C::kScaled) x *= sks[kk];
          x = cap_log2 * tanhf(x);
        } else {
          x = s[nt][e] * scale_log2;
          if constexpr (C::kScaled) x *= sks[kk];
        }
        s[nt][e] = keep ? x : lc::kNegInf;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};

    // P = exp(S - m_new): f32 into the row sums; bf16 (quantized: p * vs[j])
    // into the A fragments of P.V
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
      if constexpr (C::kScaled) {
        const float v0 = svs[nt * 8 + t4 * 2], v1 = svs[nt * 8 + t4 * 2 + 1];
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
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
      const uint16_t* vr = sv + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const uint16_t* vcol = vr + dt * 8;
        uint32_t bf[2] = {
            static_cast<uint32_t>(vcol[0]) |
                (static_cast<uint32_t>(vcol[LDS]) << 16),
            static_cast<uint32_t>(vcol[8 * LDS]) |
                (static_cast<uint32_t>(vcol[9 * LDS]) << 16)};
        lc::mma_bf16_16816(acc[dt], pa[kk], bf);
      }
    }
  }

  // out = acc / max(l, 1e-30)
  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + i * 8;
    if (row >= n_rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if constexpr (kLse) {  // rows (g, t) of one KV head: flattened (H, T)
      if (t4 == 0)
        lse[head0 / D + row] =
            m[i] == lc::kNegInf
                ? lc::kNegInf
                : 0.6931471805599453f * (m[i] + log2f(den));
    }
    uint16_t* orow = ob + (size_t)row * D + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = lc::pack_bf16x2(
          acc[dt][2 * i] / den, acc[dt][2 * i + 1] / den);
  }
}

template <class C, int D, bool kPaged>
int launch_d(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* base, void* o,
             void* lse, int B, int H, int Hkv, int T, int S, int page,
             int window, float scale, float softcap, cudaStream_t stream) {
  constexpr float kLog2e = 1.4426950408889634f;
  const dim3 grid((H / Hkv * T + kBQ - 1) / kBQ, Hkv, B);
  const bool cap = softcap > 0.f;
  auto kern = lse ? (cap ? chunk_attn_kernel<C, D, kPaged, true, true>
                         : chunk_attn_kernel<C, D, kPaged, false, true>)
                  : (cap ? chunk_attn_kernel<C, D, kPaged, true, false>
                         : chunk_attn_kernel<C, D, kPaged, false, false>);
  constexpr int smem = lc::fwd_dyn_smem_bytes(D, kBQ);
  if constexpr (smem > 0) {
    // per instantiation: [lse][cap]
    static unsigned long long attr_devices[2][2] = {{0, 0}, {0, 0}};
    const cudaError_t e = lc::smem_limit_per_device(
        kern, smem, attr_devices[lse != nullptr][cap]);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const typename C::T*>(k),
      static_cast<const typename C::T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(base), static_cast<uint16_t*>(o),
      static_cast<float*>(lse), H, Hkv, T, S, page, window, scale * kLog2e,
      cap ? scale / softcap : 0.f, cap ? softcap * kLog2e : 0.f);
  return static_cast<int>(cudaGetLastError());
}

// ``page`` > 0 selects the paged addressing: k, v (and the scales) are pools,
// ``table`` is (B, S / page) and S = P_max * page. ``window`` <= 0 and
// ``softcap`` <= 0: none.
template <class C>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* base, void* o,
           void* lse, int B, int H, int Hkv, int T, int S, int page, int D,
           int window, float scale, float softcap, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv != 0 ||
      T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (page > 0) {
    switch (D) {
      case 64: return launch_d<C, 64, true>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv, T, S, page, window, scale, softcap, s);
      case 128: return launch_d<C, 128, true>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv, T, S, page, window, scale, softcap, s);
      case 256: return launch_d<C, 256, true>(q, k, v, ks, vs, table, base, o, lse, B, H, Hkv, T, S, page, window, scale, softcap, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (D) {
    case 64: return launch_d<C, 64, false>(q, k, v, ks, vs, nullptr, base, o, lse, B, H, Hkv, T, S, 1, window, scale, softcap, s);
    case 128: return launch_d<C, 128, false>(q, k, v, ks, vs, nullptr, base, o, lse, B, H, Hkv, T, S, 1, window, scale, softcap, s);
    case 256: return launch_d<C, 256, false>(q, k, v, ks, vs, nullptr, base, o, lse, B, H, Hkv, T, S, 1, window, scale, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point returns cudaGetLastError() after the launch (0 =
// launched). Head dims 64, 128 and 256 are instantiated; any GQA group and any
// T >= 1. ``window`` <= 0 means no window, ``softcap`` <= 0 no cap; ``lse``
// is null (no lse) or (B, H, T) f32. They launch on ``stream``, do not
// synchronise and allocate nothing.
extern "C" int lc_chunk_attn_bf16(const void* q, const void* k, const void* v,
                                  const void* base_lengths, void* o,
                                  void* lse, int B, int H, int Hkv, int T,
                                  int S, int D, int window, float softcap,
                                  float scale, void* stream) {
  return launch<lc::CacheBf16>(q, k, v, nullptr, nullptr, nullptr,
                               base_lengths, o, lse, B, H, Hkv, T, S, 0, D,
                               window, scale, softcap, stream);
}

// A quantized cache: ``fp8`` selects e4m3 values (else int8); k_scale and
// v_scale are (B, Hkv, S) f32.
extern "C" int lc_chunk_attn_q(const void* q, const void* k, const void* v,
                               const void* k_scale, const void* v_scale,
                               const void* base_lengths, void* o, void* lse,
                               int B, int H, int Hkv, int T, int S, int D,
                               int fp8, int window, float softcap,
                               float scale, void* stream) {
  if (fp8)
    return launch<lc::CacheE4m3>(q, k, v, k_scale, v_scale, nullptr,
                                 base_lengths, o, lse, B, H, Hkv, T, S, 0, D,
                                 window, scale, softcap, stream);
  return launch<lc::CacheInt8>(q, k, v, k_scale, v_scale, nullptr,
                               base_lengths, o, lse, B, H, Hkv, T, S, 0, D,
                               window, scale, softcap, stream);
}

// Paged pools: k_pages, v_pages (num_pages, Hkv, page, D) bf16; page_table
// (B, P_max) int32. Any page size >= 1; the pools must hold fewer than 2^32
// rows (num_pages * Hkv * page).
extern "C" int lc_paged_chunk_attn_bf16(const void* q, const void* k_pages,
                                        const void* v_pages,
                                        const void* page_table,
                                        const void* base_lengths, void* o,
                                        void* lse, int B, int H, int Hkv,
                                        int T, int P_max, int page, int D,
                                        int window, float softcap,
                                        float scale, void* stream) {
  if (page <= 0 || P_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<lc::CacheBf16>(q, k_pages, v_pages, nullptr, nullptr,
                               page_table, base_lengths, o, lse, B, H, Hkv, T,
                               P_max * page, page, D, window, scale, softcap,
                               stream);
}

// Quantized paged pools: int8 or (``fp8``) e4m3 values with f32 scale pools
// (num_pages, Hkv, page).
extern "C" int lc_paged_chunk_attn_q(const void* q, const void* k_pages,
                                     const void* v_pages, const void* k_scales,
                                     const void* v_scales,
                                     const void* page_table,
                                     const void* base_lengths, void* o,
                                     void* lse, int B, int H, int Hkv, int T,
                                     int P_max, int page, int D, int fp8,
                                     int window, float softcap, float scale,
                                     void* stream) {
  if (page <= 0 || P_max <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (fp8)
    return launch<lc::CacheE4m3>(q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, base_lengths, o, lse, B, H, Hkv,
                                 T, P_max * page, page, D, window, scale,
                                 softcap, stream);
  return launch<lc::CacheInt8>(q, k_pages, v_pages, k_scales, v_scales,
                               page_table, base_lengths, o, lse, B, H, Hkv, T,
                               P_max * page, page, D, window, scale, softcap,
                               stream);
}
