// Row-reduction ops for Hopper: rms-norm, layer-norm (forward and
// backward) and row softmax (naive, safe and online). Each row of an (S, K)
// matrix gets f32 statistics, then an elementwise pass.
//
// Replaces: leetcuda_tpu/ops/rms_norm.py make_rms_norm (_rms_norm_kernel),
// ops/layer_norm.py make_layer_norm (_layer_norm_kernel) and
// make_layer_norm_trainable (_ln_bwd_kernel), ops/softmax.py _make_rowwise
// (_naive_softmax_kernel, _safe_softmax_kernel, _online_softmax_kernel).
//
// Bound on an H100 SXM: bytes. A forward reads x once and writes its output
// once (a (16384, 2048) bf16 rms-norm: 134 MB, 40 us at 3.35 TB/s); the
// arithmetic is a few operations an element. Design, simple first: one CTA
// per row (the TPU kernel's rows_per_step is tiling and does not carry
// over). Its threads walk the row in chunks of VEC elements, the rung of the
// JAX ladder (1, 2, 4 or 8 elements a thread a step), loaded LB bytes at a
// time (the "pack" rungs: one 16-byte load of 8 half-width elements). A row
// whose start is not LB-aligned, or whose length is not a multiple of VEC,
// takes single elements before the first aligned address and after the
// last whole vector, so every rung takes any K and any S. Statistics are f32
// and reduced by warp shuffles, then across warps through shared memory in a
// fixed order. Each pass over the row reads it again (from L1 / L2): the
// variance is the mean of squared deviations from the mean, two passes, as
// JAX computes it (E[x^2] - mean^2 would cancel on rows with a large mean).
// Outputs are new buffers: x is never written (the TPU kernels alias x to
// their output, which XLA undoes by copying when x is still live).
//
// The layer-norm forward has two routes (ops/layer_norm.py ln_fwd_plan
// picks one from the shape): "rows" (ln_fwd_rows), K a multiple of 8 up to
// 4096 and 16-byte aligned rows, reads each row from device memory once: a
// group of 1-8 warps owns a row at a time (8 at K = 2048), the CTA's 256
// threads several groups, a persistent grid of 2-4 CTAs an SM taking
// rows slot, slot + slots, ...; each thread keeps its columns of gamma and beta
// in registers as f32 for all its rows, holds its 8-column vectors of the
// row as loaded (in the rung's load width), keeps the next row's loads in
// flight while it reduces this one, and reduces by warp shuffles and the
// group's warps behind one named barrier (the mean, then the two-pass
// variance from the registers); y goes out in 16-byte stores. "block"
// (layer_norm_kernel) is the walk above, for every other K or alignment.
// The rms-norm has the same two routes (ops/rms_norm.py rms_plan): "rows"
// is ln_fwd_rows with kRms, which drops the mean and beta: one reduction a
// row (the sum of squares), so a group of 8 warps pays one named barrier a
// row, not two, and a thread holds only w as f32 beside its two rows;
// "block" is rms_norm_kernel, the walk above.
//
// The backward of layer-norm recomputes each row's statistics from x, as the
// TPU kernel does: dx = (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) rstd
// with dxhat = dy g, and dgamma = sum dy xhat, dbeta = sum dy over the rows.
// Its bound is bytes: x and dy read once, dx written once ((16384, 2048)
// bf16: 201 MB, 0.060 ms at 3.35 TB/s). Two routes (ops/layer_norm.py
// ln_bwd_plan picks one):
// - "rows" (ln_bwd_rows), K a multiple of 8 up to 4096 and 16-byte aligned
//   rows: a group of 4 warps owns a row at a time, two groups a CTA, a
//   persistent grid of 2 CTAs an SM (1 above K = 2048) taking rows slot,
//   slot + 2 grid, ... Each thread holds its 8-column vectors of the row's
//   x and dy in registers as loaded (16-byte loads, x and dy read from
//   memory once), issues the next row's loads before it reduces this one,
//   and reduces the row by warp shuffles and the group's 4 warps through
//   shared memory behind one named barrier a reduction (the mean, the
//   two-pass variance, then m1 = mean(dxhat) and m2 = mean(dxhat xhat) in
//   one paired reduction). Its dgamma and dbeta partials stay in registers
//   over all the CTA's rows; the CTA writes one row of each (group 0's plus
//   group 1's) once.
// - "block" (ln_bwd_kernel), every other K: a CTA owns a block of rows and
//   walks each row four times, one element a load; each thread adds its
//   columns' dy xhat and dy into the CTA's row of the partial buffers after
//   every row.
// Either way the partials (nb, K) are summed by ln_bwd_finish in a fixed
// order: no float atomics, so two runs agree bit for bit.
//
// The softmax has two routes (ops/softmax.py softmax_plan picks one from
// the shape): "cluster" (softmax_cluster) reads each row from device memory
// once into the registers of a cluster of 1-16 CTAs, reduces each CTA's
// slice to (max, sum of exp), pushes the CTAs' pairs to each other through
// distributed shared memory, merges them in rank order and writes from the
// registers: one read and one write of x, where the walks below read a row
// two or three times; a row of 32000 f32 spans 4 CTAs, and 16 at 8 rows so
// that a decode step's logits fill the card. "stream" (softmax_kernel) keeps
// the walks for rows longer than 16 CTAs hold (32 KB a CTA: 256 threads x
// 128 bytes; 128K f32).
#include <type_traits>

#include "common.cuh"
#include "dtype.cuh"
#include "hopper.cuh"

#ifndef LC_SOFTMAX_SMEM
#define LC_SOFTMAX_SMEM 0  // 1: the bench's shared-memory slice variant
#endif
#ifndef LC_SOFTMAX_THREADS
#define LC_SOFTMAX_THREADS 256  // the cluster route's CTA
#endif
// The layer-norm forward's rows route's CTAs an SM (ln_fwd_ctas); the
// bench's variant builds set them otherwise
#ifndef LC_LN_THREAD_BYTES
#define LC_LN_THREAD_BYTES 640
#endif
#ifndef LC_LN_MAX_CTAS
#define LC_LN_MAX_CTAS 4
#endif
#ifndef LC_SOFTMAX_PROBE
#define LC_SOFTMAX_PROBE 0  // bench probes (wrong results): 1 no arithmetic,
#endif                      // 2 no cluster exchange

namespace {

using namespace lc;  // dtype codes and conversions (dtype.cuh)

enum Mode { kNaive = 0, kSafe = 1, kOnline = 2 };
constexpr int kMaxThreads = 256;

template <int LB>
struct Word;
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

// N elements at p as f32: in loads of LB bytes where p is LB-aligned, else
// one element at a time.
template <class T, int N, int LB>
__device__ __forceinline__ void load_n(const T* p, float (&v)[N]) {
  constexpr int PER = LB / sizeof(T);
  if constexpr (N % PER == 0 && PER > 1) {
    using U = typename Word<LB>::type;
    if (reinterpret_cast<uintptr_t>(p) % LB == 0) {
#pragma unroll
      for (int i = 0; i < N / PER; ++i) {
        const U u = reinterpret_cast<const U*>(p)[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < PER; ++j) v[i * PER + j] = to_f32(e[j]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = to_f32(p[i]);
}

template <class T, int N, int LB>
__device__ __forceinline__ void store_n(T* p, const float (&v)[N]) {
  constexpr int PER = LB / sizeof(T);
  if constexpr (N % PER == 0 && PER > 1) {
    using U = typename Word<LB>::type;
    if (reinterpret_cast<uintptr_t>(p) % LB == 0) {
#pragma unroll
      for (int i = 0; i < N / PER; ++i) {
        U u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int j = 0; j < PER; ++j) e[j] = from_f32<T>(v[i * PER + j]);
        reinterpret_cast<U*>(p)[i] = u;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = from_f32<T>(v[i]);
}

// Calls f(col, width) over the K elements of ``row``, width an
// integral_constant: single elements up to the first LB-aligned address,
// whole vectors of VEC elements, then single elements past the last whole
// vector. Every element is visited once, by one thread of the CTA.
template <class T, int VEC, int LB, class F>
__device__ __forceinline__ void walk(const T* row, int K, F&& f) {
  constexpr int E = LB / sizeof(T);  // elements per aligned load
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(row) / sizeof(T)) % E);
  const int head = min(K, (E - mis) % E);
  const int nvec = (K - head) / VEC;
  const int tail = head + nvec * VEC;
  for (int c = threadIdx.x; c < head; c += blockDim.x)
    f(c, std::integral_constant<int, 1>{});
  for (int i = threadIdx.x; i < nvec; i += blockDim.x)
    f(head + i * VEC, std::integral_constant<int, VEC>{});
  for (int c = tail + threadIdx.x; c < K; c += blockDim.x)
    f(c, std::integral_constant<int, 1>{});
}

// Sum of v over the CTA, the same value in every thread: warp shuffles, then
// the warps' sums in warp order (deterministic). ``red`` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free: every thread has read its last use
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    t = fmaxf(t, red[w]);
  return t;
}

// (m, d) <- the online-softmax merge of (m, d) and (m2, d2): the max of the
// two, each denominator rescaled to it. An empty side (m = -inf, d = 0)
// leaves the other as it is.
__device__ __forceinline__ void md_merge(float& m, float& d, float m2,
                                         float d2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;
  d = d * expf(m - mx) + d2 * expf(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void block_md(float& m, float& d, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float d2 = __shfl_xor_sync(0xffffffffu, d, o);
    md_merge(m, d, m2, d2);
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = m;
    red[32 + (threadIdx.x >> 5)] = d;
  }
  __syncthreads();
  m = -INFINITY;
  d = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
    md_merge(m, d, red[w], red[32 + w]);
}

// grid (S,): y = x * rsqrt(mean(x^2) + eps) * w, w (K,) of dtype wdt.
template <class T, int VEC, int LB>
__global__ void __launch_bounds__(kMaxThreads)
rms_norm_kernel(const T* __restrict__ x, const void* __restrict__ w, int wdt,
                T* __restrict__ o, int K, float eps) {
  __shared__ float red[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * K;
  T* yr = o + static_cast<size_t>(blockIdx.x) * K;
  float ss = 0.f;
  walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
    constexpr int N = decltype(width)::value;
    float v[N];
    load_n<T, N, LB>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) ss = fmaf(v[i], v[i], ss);
  });
  const float inv = rsqrtf(block_sum(ss, red) / static_cast<float>(K) + eps);
  walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
    constexpr int N = decltype(width)::value;
    float v[N];
    load_n<T, N, LB>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] * inv * load_any(w, wdt, c + i);
    store_n<T, N, LB>(yr + c, v);
  });
}

// grid (S,): y = (x - mean) * rsqrt(var + eps) * g + b, var the mean of
// squared deviations; g, b (K,) of dtypes gdt, bdt.
template <class T, int VEC, int LB>
__global__ void __launch_bounds__(kMaxThreads)
layer_norm_kernel(const T* __restrict__ x, const void* __restrict__ g,
                  int gdt, const void* __restrict__ b, int bdt,
                  T* __restrict__ o, int K, float eps) {
  __shared__ float red[32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * K;
  T* yr = o + static_cast<size_t>(blockIdx.x) * K;
  float s = 0.f;
  walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
    constexpr int N = decltype(width)::value;
    float v[N];
    load_n<T, N, LB>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) s += v[i];
  });
  const float mean = block_sum(s, red) / static_cast<float>(K);
  float q = 0.f;
  walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
    constexpr int N = decltype(width)::value;
    float v[N];
    load_n<T, N, LB>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dv = v[i] - mean;
      q = fmaf(dv, dv, q);
    }
  });
  const float rstd = rsqrtf(block_sum(q, red) / static_cast<float>(K) + eps);
  walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
    constexpr int N = decltype(width)::value;
    float v[N];
    load_n<T, N, LB>(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = (v[i] - mean) * rstd * load_any(g, gdt, c + i) +
             load_any(b, bdt, c + i);
    store_n<T, N, LB>(yr + c, v);
  });
}

// The stream route of the softmax, for rows longer than a cluster of
// kSmMaxCluster CTAs holds (lc_softmax_stream). grid (S,): row softmax in
// f32. kNaive: exp(x) / sum exp(x), no max taken (it overflows to inf / NaN
// where x > 88, by design); kSafe: the row max subtracted first; kOnline:
// one pass of running (max, denominator) pairs, merged across threads, then
// the write pass exp(x - m) * (1 / d).
template <class T, int VEC, int LB>
__global__ void __launch_bounds__(kMaxThreads)
softmax_kernel(const T* __restrict__ x, T* __restrict__ o, int K, int mode) {
  __shared__ float red[64];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * K;
  T* yr = o + static_cast<size_t>(blockIdx.x) * K;
  float m = 0.f, d = 0.f;
  if (mode == kNaive) {
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) d += expf(v[i]);
    });
    d = block_sum(d, red);
  } else if (mode == kSafe) {
    m = -INFINITY;
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) m = fmaxf(m, v[i]);
    });
    m = block_max(m, red);
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) d += expf(v[i] - m);
    });
    d = block_sum(d, red);
  } else {
    m = -INFINITY;
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
      float mb = v[0];
#pragma unroll
      for (int i = 1; i < N; ++i) mb = fmaxf(mb, v[i]);
      float db = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) db += expf(v[i] - mb);
      md_merge(m, d, mb, db);
    });
    block_md(m, d, red);
  }
  if (mode == kOnline) {
    const float inv_d = 1.f / d;
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = expf(v[i] - m) * inv_d;
      store_n<T, N, LB>(yr + c, v);
    });
  } else {
    walk<T, VEC, LB>(xr, K, [&](int c, auto width) {
      constexpr int N = decltype(width)::value;
      float v[N];
      load_n<T, N, LB>(xr + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = expf(v[i] - m) / d;
      store_n<T, N, LB>(yr + c, v);
    });
  }
}

// ------------------------------------------- the softmax's cluster route

constexpr int kSmThreads = LC_SOFTMAX_THREADS;  // a CTA of the cluster route
constexpr int kSmMaxCluster = 16;  // CTAs a row (above 8: non-portable)

// One word of LB bytes as loaded or stored, streamed past L1.
template <int LB>
__device__ __forceinline__ typename Word<LB>::type ld_stream(
    const typename Word<LB>::type* p) {
  return __ldcs(p);
}
template <int LB>
__device__ __forceinline__ void st_stream(typename Word<LB>::type* p,
                                          const typename Word<LB>::type& u) {
  __stcs(p, u);
}

// exp(v) as 2^(v log2(e)) on the SFU (ex2.approx.ftz: about 2 ulp, and
// v's product with log2(e) rounded once; results below 2^-126 flush to 0),
// the cluster route's exp of every element: the caller subtracts the max
// first, exactly, so the argument's rounding stays relative to |x - m|.
__device__ __forceinline__ float fast_exp(float v) {
  return sm90::ex2(v * 1.4426950408889634f);
}

// q / d rounded to nearest, for the safe softmax's q = exp(x - m) in [0, 1]
// and its row sum d in [1, K]: y = q r with r = 1 / d rounded to nearest
// (once a row), corrected once by the exact residual q - d y (an fma):
// Markstein's step, which rounds the quotient correctly when r is and the
// quotient stays normal. Three operations where the division's general
// sequence also tests its operands' ranges.
__device__ __forceinline__ float div_by_sum(float q, float d, float r) {
  const float y = q * r;
  return fmaf(fmaf(-d, y, q), r, y);
}

// Element e of a raw word of E = LB / sizeof(T) elements, as f32 (e is a
// constant once unrolled, so the word stays in registers).
template <class T, int LB>
__device__ __forceinline__ float word_elem(const typename Word<LB>::type& u,
                                           int e) {
  return to_f32(reinterpret_cast<const T*>(&u)[e]);
}

// A persistent grid of G clusters of C = %cluster_nctarank CTAs along x:
// cluster g owns rows g, g + G, ..., each read from device memory once and
// written once. A row is a head of single elements up to the first
// LB-aligned address, nvec whole words of E = LB / sizeof(T) elements and
// a tail of fewer than E; rank r takes words [r per, min(nvec, (r + 1)
// per)), per = ceil(nvec / C), rank 0 also the head and rank C - 1 the
// tail. Thread t holds word v0 + i kSmThreads + t of its rank's range, i <
// NL, in registers as loaded, and head / tail element t. The next row's
// loads are issued before the current row's first reduction, so a CTA keeps
// a slice in flight while it reduces and writes the one it holds.
//
// Each CTA reduces its slice to (m, d): the safe and online forms the max
// (exact in any order), then the sum of exp(x - m) in f32 (a thread's
// elements in order, head first and tail last, each warp's xor tree, the
// warps in order; exp as fast_exp, as in the writes); the naive form m = 0
// and the plain sum of exp(x). The CTA pushes (m, d) into slot ``rank`` of
// every peer's shared memory (distributed shared memory) and arrives on
// that peer's mbarrier, releasing the store at cluster scope; once its own
// barrier has C arrivals it merges the C pairs in rank order with md_merge
// (for the naive form, m = 0 throughout, that is the plain sum in rank
// order), so every CTA holds the same bits, and writes its slice (safe
// exp(x - m) / d by div_by_sum, online exp(x - m) * (1 / d), naive exp(x) /
// d). No
// cluster-wide barrier a row: slots and barriers are double-buffered by
// row parity, and a peer pushes into a slot again two rows later only after
// its own barrier saw this CTA's push of the row between, which this CTA
// makes after it has read the slot. One cluster barrier at the start makes
// every CTA's barriers ready before the first push. Rows of K < E elements
// are all head.
template <class T, int LB, int NL>
__global__ void __launch_bounds__(kSmThreads)
softmax_cluster(const T* __restrict__ x, T* __restrict__ o, int S, int K,
                int mode) {
  using U = typename Word<LB>::type;
  constexpr int E = LB / static_cast<int>(sizeof(T));
  __shared__ float red[2][kSmThreads / 32];
  __shared__ float2 pairs[2][kSmMaxCluster];  // every rank's (m, d), pushed
  __shared__ uint64_t pushed[2];              // a row's C pairs landed
  const int C = static_cast<int>(sm90::cluster_nctarank());
  const int rank = C > 1 ? static_cast<int>(sm90::cluster_ctarank()) : 0;
  const int G = static_cast<int>(gridDim.x) / C;
  const int t = threadIdx.x;
  // where row r's head ends, the rank's first word and its words
  struct Cut {
    int head, tail0, v0, nmine;
  };
  auto cut = [&](int r) {
    const T* xr = x + static_cast<size_t>(r) * K;
    const int mis =
        static_cast<int>((reinterpret_cast<uintptr_t>(xr) / sizeof(T)) % E);
    Cut c;
    c.head = min(K, (E - mis) % E);
    const int nvec = (K - c.head) / E;
    c.tail0 = c.head + nvec * E;
    const int per = (nvec + C - 1) / C;
    c.v0 = min(nvec, rank * per);
    c.nmine = min(nvec, c.v0 + per) - c.v0;
    return c;
  };
  // LC_SOFTMAX_SMEM (a bench variant, 16-byte words only): each slice by
  // one bulk copy into a shared-memory buffer (two, by row parity) on an
  // mbarrier, then into the same registers
  constexpr bool kBulk = LC_SOFTMAX_SMEM && LB == 16;
  extern __shared__ uint4 slices[];  // kBulk: two of NL kSmThreads words
  auto slice = [&](int b) {
    return reinterpret_cast<U*>(slices) + b * NL * kSmThreads;
  };
  __shared__ uint64_t bar[2];
  if constexpr (kBulk) {
    if (t == 0) {
      sm90::mbar_init(&bar[0], 1);
      sm90::mbar_init(&bar[1], 1);
      sm90::fence_mbar_init();
    }
    __syncthreads();
  }
  // issue row r's loads (into ``raw``, or the bulk copy into buffer b),
  // and its head / tail elements
  auto issue = [&](int r, int b, U (&raw)[NL], float& hv, float& tv) {
    const Cut c = cut(r);
    const T* xr = x + static_cast<size_t>(r) * K;
    const U* wr = reinterpret_cast<const U*>(xr + c.head) + c.v0;
    if constexpr (kBulk) {
      if (t == 0) {
        sm90::fence_proxy_async_shared();
        const uint32_t bytes = static_cast<uint32_t>(c.nmine) * LB;
        sm90::mbar_expect_tx(&bar[b], bytes);
        if (bytes) sm90::bulk_load(slice(b), wr, bytes, &bar[b]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (i * kSmThreads + t < c.nmine)
          raw[i] = ld_stream<LB>(wr + i * kSmThreads + t);
    }
    hv = rank == 0 && t < c.head ? to_f32(xr[t]) : 0.f;
    tv = rank == C - 1 && t < K - c.tail0 ? to_f32(xr[c.tail0 + t]) : 0.f;
  };

  int r = static_cast<int>(blockIdx.x) / C;
  U cur[NL];
  float ch = 0.f, ct = 0.f;
  if (C > 1 && t == 0) {
    sm90::mbar_init(&pushed[0], C);
    sm90::mbar_init(&pushed[1], C);
    sm90::fence_mbar_init();
  }
  if (C > 1) sm90::cluster_arrive();  // this CTA's barriers ready
  if (r < S) issue(r, 0, cur, ch, ct);
  if (C > 1) sm90::cluster_wait();  // every peer's, before the first push
  for (int it = 0; r < S; r += G, ++it) {
    U nxt[NL];
    float nh = 0.f, nt = 0.f;
    if (r + G < S) issue(r + G, (it + 1) & 1, nxt, nh, nt);
    if constexpr (kBulk) {
      sm90::mbar_wait(&bar[it & 1], (it >> 1) & 1);
      const Cut c = cut(r);
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (i * kSmThreads + t < c.nmine)
          cur[i] = slice(it & 1)[i * kSmThreads + t];
    }
    const Cut c = cut(r);
    const bool has_h = rank == 0 && t < c.head;
    const bool has_t = rank == C - 1 && t < K - c.tail0;
    float m = 0.f;
    if (mode != kNaive && LC_SOFTMAX_PROBE != 1) {
      m = has_h ? ch : -INFINITY;
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (i * kSmThreads + t < c.nmine)
#pragma unroll
          for (int e = 0; e < E; ++e)
            m = fmaxf(m, word_elem<T, LB>(cur[i], e));
      if (has_t) m = fmaxf(m, ct);
      m = block_max(m, red[0]);
    }
    float d = has_h ? fast_exp(ch - m) : 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (i * kSmThreads + t < c.nmine)
#pragma unroll
        for (int e = 0; e < E; ++e)
          d += fast_exp(word_elem<T, LB>(cur[i], e) - m);
    if (has_t) d += fast_exp(ct - m);
    if (LC_SOFTMAX_PROBE != 1) d = block_sum(d, red[1]);

    if (C > 1 && LC_SOFTMAX_PROBE == 0) {
      // thread k pushes this CTA's pair into rank k's slot ``rank`` and
      // arrives on rank k's barrier; every thread waits on this CTA's
      const int b = it & 1;
      if (t < C) {
        sm90::st_cluster_f32x2(&pairs[b][rank], t, make_float2(m, d));
        sm90::mbar_arrive_release_cluster(&pushed[b], t);
      }
      sm90::mbar_wait_acquire_cluster(&pushed[b], (it >> 1) & 1);
      m = -INFINITY;
      d = 0.f;
      for (int k = 0; k < C; ++k) md_merge(m, d, pairs[b][k].x, pairs[b][k].y);
    }

    // the writes: one rounding of f32 to T; q = exp(x - m), then q / d
    // (the safe form by div_by_sum, the naive by the division, whose q and
    // d may overflow), or q * (1 / d) for the online form (the mode tested
    // once, outside the loops)
    T* yr = o + static_cast<size_t>(r) * K;
    const bool oal = reinterpret_cast<uintptr_t>(yr + c.head) % LB == 0;
    auto write = [&](auto form) {
      constexpr int kForm = decltype(form)::value;
      const float inv = __frcp_rn(d);
      auto f = [&](float v) {
        if (LC_SOFTMAX_PROBE == 1) return v;
        const float q = fast_exp(v - m);
        return kForm == kOnline ? q * inv
               : kForm == kSafe ? div_by_sum(q, d, inv)
                                : q / d;
      };
      if (has_h) yr[t] = from_f32<T>(f(ch));
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (i * kSmThreads + t >= c.nmine) continue;
        const int v = c.v0 + i * kSmThreads + t;
        U u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int k = 0; k < E; ++k)
          e[k] = from_f32<T>(f(word_elem<T, LB>(cur[i], k)));
        if (oal) {
          st_stream<LB>(reinterpret_cast<U*>(yr + c.head) + v, u);
        } else {
#pragma unroll
          for (int k = 0; k < E; ++k) yr[c.head + v * E + k] = e[k];
        }
      }
      if (has_t) yr[c.tail0 + t] = from_f32<T>(f(ct));
    };
    if (mode == kOnline)
      write(std::integral_constant<int, kOnline>{});
    else if (mode == kSafe)
      write(std::integral_constant<int, kSafe>{});
    else
      write(std::integral_constant<int, kNaive>{});
#pragma unroll
    for (int i = 0; i < NL; ++i) cur[i] = nxt[i];
    ch = nh;
    ct = nt;
  }
}

// The bench's bulk-copy variant's two slices (dynamic shared memory).
template <class T, int LB, int NL>
constexpr int softmax_smem() {
  return LC_SOFTMAX_SMEM && LB == 16 ? 2 * NL * kSmThreads * LB : 0;
}

// The cluster route's launch: G clusters of C CTAs (1 <= C <= 16; a 16-CTA
// cluster needs the non-portable size, allowed once per device).
template <class T, int LB, int NL>
int launch_softmax_cluster(const void* x, void* o, int S, int K, int mode,
                           int C, int G, cudaStream_t st) {
  auto kern = softmax_cluster<T, LB, NL>;
  constexpr int smem = softmax_smem<T, LB, NL>();
  static unsigned long long smem_devices = 0;
  if (smem > 0) {
    const cudaError_t e = smem_limit_per_device(kern, smem, smem_devices);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  static unsigned long long wide_devices = 0;  // non-portable size allowed
  if (C > 8) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (e == cudaSuccess && !(wide_devices & bit)) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e == cudaSuccess) wide_devices |= bit;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(G) * C);
  cfg.blockDim = dim3(kSmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                                           static_cast<T*>(o), S, K, mode);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of C CTAs of one instantiation that the current device
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
template <class T, int LB, int NL>
int softmax_cluster_occupancy(int C, int* out) {
  auto kern = softmax_cluster<T, LB, NL>;
  constexpr int smem = softmax_smem<T, LB, NL>();
  cudaError_t e = cudaSuccess;
  if (C > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C * 132);
  cfg.blockDim = dim3(kSmThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kern, &cfg));
}

// A launch of the cluster route, or (out set) the occupancy query.
struct SmCall {
  const void* x;
  void* o;
  int S, K, mode, C, G;
  cudaStream_t st;
  int* out;
};

template <class T, int LB, int NL>
int softmax_call(const SmCall& a) {
  if (a.out) return softmax_cluster_occupancy<T, LB, NL>(a.C, a.out);
  return launch_softmax_cluster<T, LB, NL>(a.x, a.o, a.S, a.K, a.mode, a.C,
                                           a.G, a.st);
}

// The instantiation of (dtype, lb, nb): LB-byte words, nb = 16, 32, 64 or
// 128 bytes a thread (NL = nb / LB words). cudaErrorInvalidValue for any
// other.
int softmax_dispatch(int dtype, int lb, int nb, const SmCall& a) {
#define LC_SM_NB(T, LB)                                       \
  if (lb == (LB)) {                                           \
    if (nb == 16) return softmax_call<T, LB, 16 / (LB)>(a);   \
    if (nb == 32) return softmax_call<T, LB, 32 / (LB)>(a);   \
    if (nb == 64) return softmax_call<T, LB, 64 / (LB)>(a);   \
    if (nb == 128) return softmax_call<T, LB, 128 / (LB)>(a); \
  }
  if (dtype == kF32) {
    LC_SM_NB(float, 4)
    LC_SM_NB(float, 8)
    LC_SM_NB(float, 16)
  } else if (dtype == kF16) {
    LC_SM_NB(__half, 2)
    LC_SM_NB(__half, 4)
    LC_SM_NB(__half, 8)
    LC_SM_NB(__half, 16)
  } else if (dtype == kBF16) {
    LC_SM_NB(__nv_bfloat16, 2)
    LC_SM_NB(__nv_bfloat16, 4)
    LC_SM_NB(__nv_bfloat16, 8)
    LC_SM_NB(__nv_bfloat16, 16)
  }
#undef LC_SM_NB
  return static_cast<int>(cudaErrorInvalidValue);
}

// grid (nb,): CTA i takes rows [i * rows, min(S, (i + 1) * rows)). Per row:
// mean, rstd and xhat recomputed from x; dxhat = dy * g; m1 = mean(dxhat),
// m2 = mean(dxhat * xhat); dx = (dxhat - m1 - xhat * m2) * rstd. Thread t
// owns columns t, t + blockDim, ... and adds dy * xhat and dy of each row to
// pg[i][c] and pb[i][c] in row order.
template <class T>
__global__ void __launch_bounds__(kMaxThreads)
ln_bwd_kernel(const T* __restrict__ x, const void* __restrict__ g, int gdt,
              const T* __restrict__ dy, T* __restrict__ dx,
              float* __restrict__ pg, float* __restrict__ pb, int S, int K,
              int rows, float eps) {
  __shared__ float red[32];
  const int r0 = blockIdx.x * rows, r1 = min(S, r0 + rows);
  float* pgr = pg + static_cast<size_t>(blockIdx.x) * K;
  float* pbr = pb + static_cast<size_t>(blockIdx.x) * K;
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    pgr[c] = 0.f;
    pbr[c] = 0.f;
  }
  const float fk = static_cast<float>(K);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + static_cast<size_t>(r) * K;
    const T* dyr = dy + static_cast<size_t>(r) * K;
    T* dxr = dx + static_cast<size_t>(r) * K;
    float s = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) s += to_f32(xr[c]);
    const float mean = block_sum(s, red) / fk;
    float q = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const float dv = to_f32(xr[c]) - mean;
      q = fmaf(dv, dv, q);
    }
    const float rstd = rsqrtf(block_sum(q, red) / fk + eps);
    float a1 = 0.f, a2 = 0.f;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mean) * rstd;
      const float dxh = to_f32(dyr[c]) * load_any(g, gdt, c);
      a1 += dxh;
      a2 = fmaf(dxh, xh, a2);
    }
    const float m1 = block_sum(a1, red) / fk;
    const float m2 = block_sum(a2, red) / fk;
    for (int c = threadIdx.x; c < K; c += blockDim.x) {
      const float xh = (to_f32(xr[c]) - mean) * rstd;
      const float dyv = to_f32(dyr[c]);
      const float dxh = dyv * load_any(g, gdt, c);
      dxr[c] = from_f32<T>((dxh - m1 - xh * m2) * rstd);
      pgr[c] += dyv * xh;
      pbr[c] += dyv;
    }
  }
}

// grid (ceil(K / 32),), block (32, 8): column c = 32 blockIdx.x + x; warp y
// sums the partial rows y, y + 8, ... of pg and pb in order, then row 0 of
// the block adds the eight sums in order of y. dgamma and dbeta are
// written in dtype odt.
__global__ void __launch_bounds__(256)
ln_bwd_finish(const float* __restrict__ pg, const float* __restrict__ pb,
              void* dg, void* db, int nb, int K, int odt) {
  __shared__ float red[2][8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  float sg = 0.f, sb = 0.f;
  if (c < K) {
    for (int i = threadIdx.y; i < nb; i += 8) {
      sg += pg[static_cast<size_t>(i) * K + c];
      sb += pb[static_cast<size_t>(i) * K + c];
    }
  }
  red[0][threadIdx.y][threadIdx.x] = sg;
  red[1][threadIdx.y][threadIdx.x] = sb;
  __syncthreads();
  if (threadIdx.y != 0 || c >= K) return;
  sg = 0.f;
  sb = 0.f;
  for (int w = 0; w < 8; ++w) {
    sg += red[0][w][threadIdx.x];
    sb += red[1][w][threadIdx.x];
  }
  store_any(dg, odt, c, sg);
  store_any(db, odt, c, sb);
}

int launch_finish(const float* pg, const float* pb, void* dg, void* db,
                  int nb, int K, int odt, cudaStream_t st) {
  ln_bwd_finish<<<(K + 31) / 32, dim3(32, 8), 0, st>>>(pg, pb, dg, db, nb, K,
                                                      odt);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------- the layer-norm backward's rows route

constexpr int kRowGroup = 128;  // threads that own a row: 4 warps
constexpr int kRowsCta = 256;   // two groups

// 8 elements of T as loaded: 16 bytes (f16 / bf16) or 32 (f32).
template <class T>
struct Raw8 {
  static constexpr int W = static_cast<int>(sizeof(T)) / 2;
  uint4 w[W];
};

template <class T>
__device__ __forceinline__ void load8(Raw8<T>& r, const T* p) {
#pragma unroll
  for (int i = 0; i < Raw8<T>::W; ++i)
    r.w[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
}

// 32-bit word k (0-3) of a 16-byte word; k is a constant once unrolled, so
// the raw values stay in registers.
__device__ __forceinline__ uint32_t word(const uint4& u, int k) {
  return k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
}
__device__ __forceinline__ void set_word(uint4& u, int k, uint32_t v) {
  if (k == 0) u.x = v;
  else if (k == 1) u.y = v;
  else if (k == 2) u.z = v;
  else u.w = v;
}

// Element e (0-7) of a raw vector, as f32.
template <class T>
__device__ __forceinline__ float elem(const Raw8<T>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(word(r.w[e / 4], e % 4));
  } else {
    const uint32_t w = word(r.w[0], e / 2);
    const unsigned short h =
        static_cast<unsigned short>(e % 2 ? w >> 16 : w & 0xffffu);
    if constexpr (std::is_same_v<T, __half>)
      return __half2float(__ushort_as_half(h));
    else
      return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
}

// Eight f32 values rounded once to T and stored as 16-byte words.
template <class T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  Raw8<T> r;
#pragma unroll
  for (int k = 0; k < 2 * static_cast<int>(sizeof(T)); ++k) {  // words
    uint32_t bits;
    if constexpr (sizeof(T) == 4) {
      bits = __float_as_uint(v[k]);
      set_word(r.w[k / 4], k % 4, bits);
    } else {
      if constexpr (std::is_same_v<T, __half>) {
        const __half2 h = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
        bits = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        bits = *reinterpret_cast<const uint32_t*>(&h);
      }
      set_word(r.w[0], k, bits);
    }
  }
#pragma unroll
  for (int i = 0; i < Raw8<T>::W; ++i) reinterpret_cast<uint4*>(p)[i] = r.w[i];
}

__device__ __forceinline__ void group_barrier(int grp) {
  asm volatile("bar.sync %0, %1;" :: "r"(1 + grp), "n"(kRowGroup) : "memory");
}

// The sums of v[] over the group's 128 threads, in every thread of the
// group: warp shuffles, then the four warps' sums in warp order, through
// ``red`` (NVAL x 4 floats of this reduction's slot), behind one barrier of
// the group. A slot is written again only three reductions later, after
// two more barriers that every reader of it has passed.
template <int NVAL>
__device__ __forceinline__ void group_sum(float (&v)[NVAL], float* red,
                                          int grp, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < NVAL; ++i) v[i] = warp_sum(v[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NVAL; ++i) red[i * 4 + warp] = v[i];
  }
  group_barrier(grp);
#pragma unroll
  for (int i = 0; i < NVAL; ++i)
    v[i] = ((red[i * 4] + red[i * 4 + 1]) + red[i * 4 + 2]) + red[i * 4 + 3];
}

// grid (nb,) of 256 threads, 2 K floats of dynamic shared memory. Group
// grp of CTA b takes rows slot, slot + 2 nb, ... with slot = 2 b + grp;
// thread t of a group owns the vectors of columns (v 128 + t) 8 + [0, 8),
// v < NV, those below K. Writes row b of pg and pb.
template <class T, int NV>
__global__ void __launch_bounds__(kRowsCta, NV <= 2 ? 2 : 1)
ln_bwd_rows(const T* __restrict__ x, const void* __restrict__ g, int gdt,
            const T* __restrict__ dy, T* __restrict__ dx,
            float* __restrict__ pg, float* __restrict__ pb, int S, int K,
            float eps) {
  extern __shared__ float4 smem4[];
  float* gam = reinterpret_cast<float*>(smem4);  // [0, K) gamma
  __shared__ float red[2][3][8];
  const int grp = threadIdx.x / kRowGroup, t = threadIdx.x % kRowGroup;
  const int warp = t / 32, lane = threadIdx.x % 32;
  for (int c = threadIdx.x; c < K; c += kRowsCta) gam[c] = load_any(g, gdt, c);
  __syncthreads();

  int col[NV];
  bool live[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = (v * kRowGroup + t) * 8;
    live[v] = col[v] < K;
  }
  float ag[NV][8], ab[NV][8];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < 8; ++e) ag[v][e] = ab[v][e] = 0.f;
  auto load_row = [&](int r, Raw8<T> (&rx)[NV], Raw8<T> (&rdy)[NV]) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (live[v]) {
        load8(rx[v], x + static_cast<size_t>(r) * K + col[v]);
        load8(rdy[v], dy + static_cast<size_t>(r) * K + col[v]);
      }
    }
  };
  auto gamma8 = [&](int v, float (&gv)[8]) {
    const float4 a = reinterpret_cast<const float4*>(gam + col[v])[0];
    const float4 b = reinterpret_cast<const float4*>(gam + col[v])[1];
    gv[0] = a.x; gv[1] = a.y; gv[2] = a.z; gv[3] = a.w;
    gv[4] = b.x; gv[5] = b.y; gv[6] = b.z; gv[7] = b.w;
  };

  const float fk = static_cast<float>(K);
  const int slots = 2 * gridDim.x;
  Raw8<T> cx[NV], cdy[NV];
  int r = 2 * blockIdx.x + grp;
  if (r < S) load_row(r, cx, cdy);
  for (; r < S; r += slots) {
    Raw8<T> nx[NV], ndy[NV];
    if (r + slots < S) load_row(r + slots, nx, ndy);  // in flight meanwhile
    float s[1] = {0.f};
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (live[v])
#pragma unroll
        for (int e = 0; e < 8; ++e) s[0] += elem(cx[v], e);
    group_sum(s, red[grp][0], grp, warp, lane);
    const float mean = s[0] / fk;
    float q[1] = {0.f};
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (live[v])
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = elem(cx[v], e) - mean;
          q[0] = fmaf(d, d, q[0]);
        }
    group_sum(q, red[grp][1], grp, warp, lane);
    const float rstd = rsqrtf(q[0] / fk + eps);
    float m[2] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!live[v]) continue;
      float gv[8];
      gamma8(v, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (elem(cx[v], e) - mean) * rstd;
        const float dxh = elem(cdy[v], e) * gv[e];
        m[0] += dxh;
        m[1] = fmaf(dxh, xh, m[1]);
      }
    }
    group_sum(m, red[grp][2], grp, warp, lane);
    const float m1 = m[0] / fk, m2 = m[1] / fk;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!live[v]) continue;
      float gv[8], o[8];
      gamma8(v, gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float xh = (elem(cx[v], e) - mean) * rstd;
        const float dyv = elem(cdy[v], e);
        o[e] = (dyv * gv[e] - m1 - xh * m2) * rstd;
        ag[v][e] = fmaf(dyv, xh, ag[v][e]);
        ab[v][e] += dyv;
      }
      store8(dx + static_cast<size_t>(r) * K + col[v], o);
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      cx[v] = nx[v];
      cdy[v] = ndy[v];
    }
  }

  // the CTA's partials, group 0's plus group 1's, written once
  __syncthreads();  // gamma is read no more: its room takes group 1's
  float* ex = gam;  // [0, K) dgamma, [K, 2K) dbeta
  if (grp == 1) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (live[v])
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ex[col[v] + e] = ag[v][e];
          ex[K + col[v] + e] = ab[v][e];
        }
  }
  __syncthreads();
  if (grp != 0) return;
  float* pgr = pg + static_cast<size_t>(blockIdx.x) * K;
  float* pbr = pb + static_cast<size_t>(blockIdx.x) * K;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!live[v]) continue;
    float og[8], ob[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      og[e] = ag[v][e] + ex[col[v] + e];
      ob[e] = ab[v][e] + ex[K + col[v] + e];
    }
    float4* dg4 = reinterpret_cast<float4*>(pgr + col[v]);
    float4* db4 = reinterpret_cast<float4*>(pbr + col[v]);
    dg4[0] = make_float4(og[0], og[1], og[2], og[3]);
    dg4[1] = make_float4(og[4], og[5], og[6], og[7]);
    db4[0] = make_float4(ob[0], ob[1], ob[2], ob[3]);
    db4[1] = make_float4(ob[4], ob[5], ob[6], ob[7]);
  }
}

template <class T>
int launch_rows(const void* x, const void* g, int gdt, const void* dy,
                void* dx, float* pg, float* pb, int S, int K, int grid,
                float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const size_t smem = 2 * static_cast<size_t>(K) * sizeof(float);
  if (K <= 1024)
    ln_bwd_rows<T, 1><<<grid, kRowsCta, smem, st>>>(xt, g, gdt, dyt, dxt, pg,
                                                    pb, S, K, eps);
  else if (K <= 2048)
    ln_bwd_rows<T, 2><<<grid, kRowsCta, smem, st>>>(xt, g, gdt, dyt, dxt, pg,
                                                    pb, S, K, eps);
  else
    ln_bwd_rows<T, 4><<<grid, kRowsCta, smem, st>>>(xt, g, gdt, dyt, dxt, pg,
                                                    pb, S, K, eps);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------- the layer-norm forward's rows route

constexpr int kLnCta = 256;  // threads of a CTA of the rows route

// CTAs an SM that ln_fwd_rows is built to hold at once (its launch bounds),
// 1 to LC_LN_MAX_CTAS: LC_LN_THREAD_BYTES over the bytes of a thread's
// state of a row, two rows of its NV vectors of 8 elements of x as loaded
// (the one it reduces and the next, in flight) and its columns of gamma
// and beta as f32 (the rms-norm, kRms: w alone). At c CTAs a thread has
// 1024 / c bytes of registers. So the layer norm takes 4 CTAs at one
// vector a thread, 3 at two of a 2-byte type, 2 at two of f32: the bench's
// A/B (--ln-fwd, at 512, 640, 768 and 1024) found 2 CTAs starving the
// 2-byte rows and 4 spilling, 3 spilling f32's. The rms-norm takes 4 but
// for f32 at two vectors (3); its A/B (--rms) found 6 and 8 slower.
template <class T, int NV, bool kRms = false>
constexpr int ln_fwd_ctas() {
  constexpr int bytes =
      NV * 8 * (2 * static_cast<int>(sizeof(T)) + (kRms ? 4 : 8));
  constexpr int c = LC_LN_THREAD_BYTES / bytes;
  return c < 1 ? 1 : (c > LC_LN_MAX_CTAS ? LC_LN_MAX_CTAS : c);
}

// Eight elements of T at p into ``r``, in words of LB bytes (the rung's load
// width); 16-byte words stream past L1, narrower ones stay there, since the
// warp's next word of the same vectors reads the same sectors.
template <class T, int LB>
__device__ __forceinline__ void load8_lb(Raw8<T>& r, const T* p) {
  using U = typename Word<LB>::type;
  constexpr int N = 8 * static_cast<int>(sizeof(T)) / LB;
  U* d = reinterpret_cast<U*>(r.w);
  const U* s = reinterpret_cast<const U*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (LB == 16)
      d[i] = __ldcs(s + i);
    else
      d[i] = s[i];
  }
}

// The sum of v over a group of nw warps (warps w0 .. w0 + nw - 1 of the
// CTA), in every thread of the group: each warp's xor tree, then the warps'
// sums in warp order through ``red`` (this reduction's kLnCta / 32 floats)
// behind the group's named barrier (barrier 1 + grp, ``group`` threads).
// One warp needs no barrier. A reduction's ``red`` is written again two
// reductions later, after the barrier of the one between, which every
// reader of it has reached.
__device__ __forceinline__ float ln_group_sum(float v, float* red, int grp,
                                              int group, int w0, int nw) {
  v = warp_sum(v);
  if (nw == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(group) : "memory");
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w0 + w];
  return s;
}

// grid (grid,) of kLnCta threads in groups of ``group`` (32, 64, 128 or
// 256). Group grp of CTA c takes rows slot, slot + slots, ... with slot =
// c groups + grp and slots = groups grid; its thread t owns the 8-column
// vectors (v group + t) 8 + [0, 8), v < NV, those below K. A thread loads
// its columns of gamma and beta once, as f32, and keeps them in registers
// for every row; it holds its vectors of a row as loaded (words of LB
// bytes) and keeps the next row's loads in flight while it reduces this
// one. A row's mean, then the mean of squared deviations from it (two
// passes over the registers), each a thread's elements in order, then
// ln_group_sum; y = (x - mean) rstd g + b, rounded once and stored as
// 16-byte words. With kRms (g is the rms-norm's w, b unused): the sum of
// x^2 by fmaf, a thread's elements in order, then one ln_group_sum; y = x
// rstd w with rstd = rsqrt(sum / K + eps), rounded once. Its one reduction
// a row alternates red[0] and red[1] between the loop's two row buffers,
// so that a row's ``red`` is written again only past the next row's
// barrier.
template <class T, int LB, int NV, bool kRms = false>
__global__ void __launch_bounds__(kLnCta, ln_fwd_ctas<T, NV, kRms>())
ln_fwd_rows(const T* __restrict__ x, const void* __restrict__ g, int gdt,
            const void* __restrict__ b, int bdt, T* __restrict__ o, int S,
            int K, int group, float eps) {
  __shared__ float red[2][kLnCta / 32];
  const int grp = threadIdx.x / group, t = threadIdx.x % group;
  const int groups = kLnCta / group, nw = group / 32, w0 = grp * nw;
  int col[NV];
  bool live[NV];
  float gv[NV][8], bv[NV][8];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    col[v] = (v * group + t) * 8;
    live[v] = col[v] < K;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      gv[v][e] = live[v] ? load_any(g, gdt, col[v] + e) : 0.f;
      if constexpr (!kRms)
        bv[v][e] = live[v] ? load_any(b, bdt, col[v] + e) : 0.f;
    }
  }
  auto load_row = [&](int r, Raw8<T>(&rx)[NV]) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      if (live[v])
        load8_lb<T, LB>(rx[v], x + static_cast<size_t>(r) * K + col[v]);
  };
  const float fk = static_cast<float>(K);
  auto norm_row = [&](const Raw8<T>(&cx)[NV], int r, int buf) {
    if constexpr (kRms) {
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (live[v])
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float xe = elem(cx[v], e);
            q = fmaf(xe, xe, q);
          }
      q = ln_group_sum(q, red[buf], grp, group, w0, nw);
      const float rstd = rsqrtf(q / fk + eps);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!live[v]) continue;
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) y[e] = elem(cx[v], e) * rstd * gv[v][e];
        store8<T>(o + static_cast<size_t>(r) * K + col[v], y);
      }
    } else {
      float m = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (live[v])
#pragma unroll
          for (int e = 0; e < 8; ++e) m += elem(cx[v], e);
      m = ln_group_sum(m, red[0], grp, group, w0, nw) / fk;
      float q = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        if (live[v])
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = elem(cx[v], e) - m;
            q = fmaf(d, d, q);
          }
      q = ln_group_sum(q, red[1], grp, group, w0, nw);
      const float rstd = rsqrtf(q / fk + eps);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (!live[v]) continue;
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          y[e] = (elem(cx[v], e) - m) * rstd * gv[v][e] + bv[v][e];
        store8<T>(o + static_cast<size_t>(r) * K + col[v], y);
      }
    }
  };

  // two buffers of a row, the loop two rows a pass, so that each keeps its
  // registers (a copy would wait on the loads in flight)
  const int slots = groups * static_cast<int>(gridDim.x);
  int r = static_cast<int>(blockIdx.x) * groups + grp;
  Raw8<T> ra[NV], rb[NV];
  if (r < S) load_row(r, ra);
  for (; r < S; r += 2 * slots) {
    if (r + slots < S) load_row(r + slots, rb);
    norm_row(ra, r, 0);
    if (r + slots >= S) break;
    if (r + 2 * slots < S) load_row(r + 2 * slots, ra);
    norm_row(rb, r + slots, 1);
  }
}

template <class T, int LB, bool kRms>
int launch_ln_rows(const void* x, const void* g, int gdt, const void* b,
                   int bdt, void* o, int S, int K, int group, int grid,
                   float eps, cudaStream_t st) {
  const int nv = (K / 8 + group - 1) / group;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (nv == 1)
    ln_fwd_rows<T, LB, 1, kRms><<<grid, kLnCta, 0, st>>>(
        xt, g, gdt, b, bdt, ot, S, K, group, eps);
  else if (nv == 2)
    ln_fwd_rows<T, LB, 2, kRms><<<grid, kLnCta, 0, st>>>(
        xt, g, gdt, b, bdt, ot, S, K, group, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The rung's load width of element type T: 4, 8 or 16 bytes for f32; 2, 4,
// 8 or 16 for f16 and bf16.
template <class T, bool kRms>
int ln_rows_by_lb(int lb, const void* x, const void* g, int gdt,
                  const void* b, int bdt, void* o, int S, int K, int group,
                  int grid, float eps, cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    if (lb == 2)
      return launch_ln_rows<T, 2, kRms>(x, g, gdt, b, bdt, o, S, K, group,
                                        grid, eps, st);
  }
  if (lb == 4)
    return launch_ln_rows<T, 4, kRms>(x, g, gdt, b, bdt, o, S, K, group, grid,
                                      eps, st);
  if (lb == 8)
    return launch_ln_rows<T, 8, kRms>(x, g, gdt, b, bdt, o, S, K, group, grid,
                                      eps, st);
  if (lb == 16)
    return launch_ln_rows<T, 16, kRms>(x, g, gdt, b, bdt, o, S, K, group,
                                       grid, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Both norms' rows route: checks what ln_fwd_rows takes, then its launch
// by dtype and load width.
template <bool kRms>
int rows_route(const void* x, const void* g, int gdt, const void* b, int bdt,
               void* o, int S, int K, int dtype, int lb, int group, int grid,
               float eps, void* stream) {
  if (S <= 0 || K <= 0 || K % 8 || grid <= 0 || gdt < 0 || gdt > 2 ||
      bdt < 0 || bdt > 2 ||
      (group != 32 && group != 64 && group != 128 && group != 256) ||
      K > 16 * group ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return ln_rows_by_lb<float, kRms>(lb, x, g, gdt, b, bdt, o, S, K, group,
                                      grid, eps, st);
  if (dtype == kF16)
    return ln_rows_by_lb<__half, kRms>(lb, x, g, gdt, b, bdt, o, S, K, group,
                                       grid, eps, st);
  if (dtype == kBF16)
    return ln_rows_by_lb<__nv_bfloat16, kRms>(lb, x, g, gdt, b, bdt, o, S, K,
                                              group, grid, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

enum Op { kRms = 0, kLayerNorm = 1, kSoftmax = 2 };

template <class T, int VEC, int LB>
void launch_row(int op, const void* x, const void* w, int wdt, const void* b,
                int bdt, void* o, int S, int K, float eps, int mode,
                int threads, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (op == kRms)
    rms_norm_kernel<T, VEC, LB><<<S, threads, 0, st>>>(xt, w, wdt, ot, K,
                                                       eps);
  else if (op == kLayerNorm)
    layer_norm_kernel<T, VEC, LB><<<S, threads, 0, st>>>(xt, w, wdt, b, bdt,
                                                         ot, K, eps);
  else
    softmax_kernel<T, VEC, LB><<<S, threads, 0, st>>>(xt, ot, K, mode);
}

// The instantiated (VEC, LB) pairs of each element type: 1, 2, 4 and 8
// elements a thread, in their natural loads, and 8 in 4-byte loads (the
// f16x8 rungs: four half2 loads, as the reference's ladder reads them).
template <class T>
int dispatch(int vec, int lb, int op, const void* x, const void* w, int wdt,
             const void* b, int bdt, void* o, int S, int K, float eps,
             int mode, int threads, cudaStream_t st) {
  constexpr int Z = sizeof(T);
#define LC_CASE(V, L)                                                      \
  if (vec == (V) && lb == (L)) {                                          \
    launch_row<T, V, L>(op, x, w, wdt, b, bdt, o, S, K, eps, mode, threads, \
                        st);                                              \
    return static_cast<int>(cudaGetLastError());                          \
  }
  LC_CASE(1, Z)
  LC_CASE(2, 2 * Z)
  LC_CASE(4, (4 * Z < 16 ? 4 * Z : 16))
  LC_CASE(8, 4)
  LC_CASE(8, 16)
#undef LC_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int row_op(int op, const void* x, const void* w, int wdt, const void* b,
           int bdt, void* o, int S, int K, int dtype, int vec, int lb,
           float eps, int mode, int threads, void* stream) {
  if (S <= 0 || K <= 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || wdt < 0 || wdt > 2 || bdt < 0 || bdt > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(vec, lb, op, x, w, wdt, b, bdt, o, S, K, eps, mode,
                           threads, st);
  if (dtype == kF16)
    return dispatch<__half>(vec, lb, op, x, w, wdt, b, bdt, o, S, K, eps,
                            mode, threads, st);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(vec, lb, op, x, w, wdt, b, bdt, o, S, K,
                                   eps, mode, threads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Every entry point returns cudaGetLastError() after its launch(es) (0 =
// launched), launches on ``stream``, does not synchronise and allocates
// nothing. x and the output are contiguous (S, K) of dtype ``dtype`` (0 f32,
// 1 f16, 2 bf16); the weight vectors (K,) are of their own dtypes. ``vec``
// and ``lb``: the rung, elements a thread takes a step and bytes a load
// (pairs (1, size), (2, 2 size), (4, min(4 size, 16)), (8, 4), (8, 16));
// ``threads`` a multiple of 32 up to 256.
extern "C" int lc_rms_norm(const void* x, const void* w, int wdt, void* o,
                           int S, int K, int dtype, int vec, int lb,
                           float eps, int threads, void* stream) {
  return row_op(kRms, x, w, wdt, nullptr, 0, o, S, K, dtype, vec, lb, eps, 0,
                threads, stream);
}

extern "C" int lc_layer_norm_fwd(const void* x, const void* g, int gdt,
                                 const void* b, int bdt, void* o, int S,
                                 int K, int dtype, int vec, int lb, float eps,
                                 int threads, void* stream) {
  return row_op(kLayerNorm, x, g, gdt, b, bdt, o, S, K, dtype, vec, lb, eps,
                0, threads, stream);
}

// The layer-norm forward's rows route: the same operands as
// lc_layer_norm_fwd, K a multiple of 8 with at most 2 vectors of 8 a thread
// of a group (K <= 16 group), x and o 16-byte aligned; ``group`` threads a
// row (32, 64, 128 or 256), ``grid`` CTAs of 256 threads, loads of ``lb``
// bytes (4, 8 or 16; 2 for f16 and bf16 too). ops/layer_norm.py
// ln_fwd_plan picks them.
extern "C" int lc_layer_norm_rows(const void* x, const void* g, int gdt,
                                  const void* b, int bdt, void* o, int S,
                                  int K, int dtype, int lb, int group,
                                  int grid, float eps, void* stream) {
  return rows_route<false>(x, g, gdt, b, bdt, o, S, K, dtype, lb, group, grid,
                           eps, stream);
}

// The rms-norm's rows route: lc_rms_norm's operands, and K, the alignment,
// ``lb``, ``group`` and ``grid`` as lc_layer_norm_rows takes them.
// ops/rms_norm.py rms_plan picks them.
extern "C" int lc_rms_norm_rows(const void* x, const void* w, int wdt,
                                void* o, int S, int K, int dtype, int lb,
                                int group, int grid, float eps,
                                void* stream) {
  return rows_route<true>(x, w, wdt, nullptr, 0, o, S, K, dtype, lb, group,
                          grid, eps, stream);
}

// The softmax's stream route (rows longer than a cluster holds): one CTA a
// row walking it in rung steps. ``mode``: 0 naive, 1 safe, 2 online.
extern "C" int lc_softmax_stream(const void* x, void* o, int S, int K,
                                 int dtype, int vec, int lb, int mode,
                                 int threads, void* stream) {
  if (mode < kNaive || mode > kOnline)
    return static_cast<int>(cudaErrorInvalidValue);
  return row_op(kSoftmax, x, nullptr, 0, nullptr, 0, o, S, K, dtype, vec, lb,
                0.f, mode, threads, stream);
}

// The softmax's cluster route: S rows over a persistent grid of ``clusters``
// clusters (1 to S; at most what the device holds at once) of ``cluster``
// CTAs (1-16) of kSmThreads (256) threads, each thread holding ``nb`` bytes
// (16, 32, 64 or 128) of its CTA's slice in words of ``lb`` bytes (2, 4, 8
// or 16, at least the element size). The caller guarantees
// ceil(ceil(K / (lb / size)) / cluster) <= kSmThreads nb / lb
// (ops/softmax.py softmax_plan). ``mode``: 0 naive, 1 safe, 2 online.
extern "C" int lc_softmax(const void* x, void* o, int S, int K, int dtype,
                          int lb, int nb, int cluster, int clusters, int mode,
                          void* stream) {
  if (S <= 0 || K <= 0 || mode < kNaive || mode > kOnline || cluster < 1 ||
      cluster > kSmMaxCluster || clusters < 1 || clusters > S ||
      static_cast<long long>(clusters) * cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return softmax_dispatch(dtype, lb, nb,
                          {x, o, S, K, mode, cluster, clusters,
                           static_cast<cudaStream_t>(stream), nullptr});
}

// The clusters of ``cluster`` CTAs of the cluster route's (dtype, lb, nb)
// instantiation that the current device holds at once, into *out
// (cudaOccupancyMaxActiveClusters; 0: such a cluster cannot be scheduled).
extern "C" int lc_softmax_clusters(int dtype, int lb, int nb, int cluster,
                                   int* out) {
  if (cluster < 1 || cluster > kSmMaxCluster || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return softmax_dispatch(dtype, lb, nb,
                          {nullptr, nullptr, 0, 0, 0, cluster, 0, nullptr,
                           out});
}

// The block route: x, dy, dx (S, K) of dtype ``dtype``; g (K,) of dtype gdt;
// dg, db (K,) of dtype odt; pg, pb f32 scratch of nb x K with nb =
// ceil(S / rows). Two launches: ln_bwd_kernel over nb CTAs, then
// ln_bwd_finish.
extern "C" int lc_layer_norm_bwd(const void* x, const void* g, int gdt,
                                 const void* dy, void* dx, void* pg, void* pb,
                                 void* dg, void* db, int S, int K, int dtype,
                                 int odt, int rows, float eps, int threads,
                                 void* stream) {
  if (S <= 0 || K <= 0 || rows <= 0 || threads < 32 ||
      threads > kMaxThreads || threads % 32 || gdt < 0 || gdt > 2 ||
      odt < 0 || odt > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (S + rows - 1) / rows;
  float* pgf = static_cast<float*>(pg);
  float* pbf = static_cast<float*>(pb);
  if (dtype == kF32)
    ln_bwd_kernel<float><<<nb, threads, 0, st>>>(
        static_cast<const float*>(x), g, gdt, static_cast<const float*>(dy),
        static_cast<float*>(dx), pgf, pbf, S, K, rows, eps);
  else if (dtype == kF16)
    ln_bwd_kernel<__half><<<nb, threads, 0, st>>>(
        static_cast<const __half*>(x), g, gdt, static_cast<const __half*>(dy),
        static_cast<__half*>(dx), pgf, pbf, S, K, rows, eps);
  else if (dtype == kBF16)
    ln_bwd_kernel<__nv_bfloat16><<<nb, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), g, gdt,
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), pgf, pbf, S, K, rows, eps);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_finish(pgf, pbf, dg, db, nb, K, odt, st);
}

// The rows route: the same operands, K a multiple of 8 up to 4096, x, dy
// and dx 16-byte aligned; ``grid`` CTAs (nb = grid partial rows of pg and
// pb, at most 2 an SM: 1 above K = 2048). Two launches: ln_bwd_rows, then
// ln_bwd_finish.
extern "C" int lc_layer_norm_bwd_rows(const void* x, const void* g, int gdt,
                                      const void* dy, void* dx, void* pg,
                                      void* pb, void* dg, void* db, int S,
                                      int K, int dtype, int odt, int grid,
                                      float eps, void* stream) {
  if (S <= 0 || K <= 0 || K % 8 || K > 4096 || grid <= 0 || gdt < 0 ||
      gdt > 2 || odt < 0 || odt > 2 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pgf = static_cast<float*>(pg);
  float* pbf = static_cast<float*>(pb);
  int err;
  if (dtype == kF32)
    err = launch_rows<float>(x, g, gdt, dy, dx, pgf, pbf, S, K, grid, eps,
                             st);
  else if (dtype == kF16)
    err = launch_rows<__half>(x, g, gdt, dy, dx, pgf, pbf, S, K, grid, eps,
                              st);
  else if (dtype == kBF16)
    err = launch_rows<__nv_bfloat16>(x, g, gdt, dy, dx, pgf, pbf, S, K, grid,
                                     eps, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return launch_finish(pgf, pbf, dg, db, grid, K, odt, st);
}
