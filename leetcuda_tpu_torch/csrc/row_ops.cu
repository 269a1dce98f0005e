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
// The backward of layer-norm recomputes each row's statistics from x, as the
// TPU kernel does. A CTA owns a block of rows; each thread owns a fixed set
// of columns, so it sums dgamma = sum dy * xhat and dbeta = sum dy of its
// columns over the block's rows into the CTA's row of an f32 partial buffer
// (nb, K), with no other thread touching them. ln_bwd_finish sums the nb
// partials of each column in order: no float atomics, so two runs agree bit
// for bit.
#include <type_traits>

#include "common.cuh"
#include "dtype.cuh"

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

// grid (S,): row softmax in f32. kNaive: exp(x) / sum exp(x), no max taken
// (it overflows to inf / NaN where x > 88, by design); kSafe: the row max
// subtracted first; kOnline: one pass of running (max, denominator) pairs,
// merged across threads, then the write pass exp(x - m) * (1 / d).
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

// grid (ceil(K / 256),): dgamma[c] = sum over i of pg[i][c], in order of i,
// the same for dbeta; written in dtype odt.
__global__ void ln_bwd_finish(const float* __restrict__ pg,
                              const float* __restrict__ pb, void* dg, void* db,
                              int nb, int K, int odt) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= K) return;
  float sg = 0.f, sb = 0.f;
  for (int i = 0; i < nb; ++i) {
    sg += pg[static_cast<size_t>(i) * K + c];
    sb += pb[static_cast<size_t>(i) * K + c];
  }
  store_any(dg, odt, c, sg);
  store_any(db, odt, c, sb);
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

// ``mode``: 0 naive, 1 safe, 2 online.
extern "C" int lc_softmax(const void* x, void* o, int S, int K, int dtype,
                          int vec, int lb, int mode, int threads,
                          void* stream) {
  if (mode < kNaive || mode > kOnline)
    return static_cast<int>(cudaErrorInvalidValue);
  return row_op(kSoftmax, x, nullptr, 0, nullptr, 0, o, S, K, dtype, vec, lb,
                0.f, mode, threads, stream);
}

// x, dy, dx (S, K) of dtype ``dtype``; g (K,) of dtype gdt; dg, db (K,) of
// dtype odt; pg, pb f32 scratch of nb x K with nb = ceil(S / rows). Two
// launches: ln_bwd_kernel over nb CTAs, then ln_bwd_finish.
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
  ln_bwd_finish<<<(K + 255) / 256, 256, 0, st>>>(pgf, pbf, dg, db, nb, K,
                                                 odt);
  return static_cast<int>(cudaGetLastError());
}
