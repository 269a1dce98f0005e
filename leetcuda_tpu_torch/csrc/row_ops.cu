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
