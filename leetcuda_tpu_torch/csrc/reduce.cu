// Whole-array reductions for Hopper: the sum (any of the reference's element
// and accumulator types), the max and the dot product of a flat contiguous
// (S, K), each to one value.
//
// Replaces: leetcuda_tpu/ops/reduce.py make_block_all_reduce_sum
// (_reduce_sum_kernel) and make_block_all_reduce_max (_reduce_max_kernel),
// and ops/dot_product.py make_dot_product (_dot_kernel).
//
// Bound on an H100 SXM: bytes. Each input element is read once and the
// arithmetic is one add (or max, or multiply-add) an element (a (16384,
// 2048) f32 sum: 134 MB, 40 us at 3.35 TB/s). The TPU kernels carry their
// accumulator from one sequential grid step to the next; here CTAs run in
// parallel and in no order, so the reduction takes two passes and no
// atomics. Pass 1: each of up to kMaxPartials CTAs walks a grid-stride share
// of the array, VEC elements a thread a step (the rung of the JAX ladder) in
// loads of LB bytes (16 for the packed rungs), the elements before the first
// aligned address and after the last whole vector one at a time in CTA 0;
// it reduces its threads' values by warp shuffles, then its warps' in warp
// order through shared memory, and writes one partial. Pass 2: one CTA
// reduces the partials in the same fixed order and writes the result. The
// order of every operation depends only on n, the rung and x's alignment,
// so a result is the same bits on every run. Float inputs are decoded to
// f32 (e4m3 and e5m2 by the hardware cvt; e4m3's bytes 0x7F and 0xFF are
// NaN) and accumulate in f32; the result is rounded once to the
// accumulator's type: the f16 and bf16 accumulators of the ladder hold an
// f32 sum rounded once, which is what the TPU computed for them
// (reduce.py _kernel_acc_dtype). int8 sums accumulate in uint32, wrapping
// mod 2^32 as JAX's int32 sum does, and are written as int32. The max
// propagates NaN (fmaxf would drop it) and is -inf over no element.
#include <cuda_fp8.h>

#include <type_traits>

#include "dtype.cuh"
#include "vec_io.cuh"

namespace {

using namespace lc;

enum In { kInF32 = 0, kInF16 = 1, kInBF16 = 2, kInI8 = 3, kInE4M3 = 4,
          kInE5M2 = 5 };
constexpr int kOutI32 = 6;
enum Red { kSum = 0, kMax = 1, kDot = 2 };
constexpr int kThreads = 256;
constexpr int kMaxPartials = 1024;  // ops/reduce.py MAX_PARTIALS
constexpr int kStepsPerThread = 8;  // pass 1 CTAs: one per 8 vectors a thread

template <int K> struct Elem;
template <> struct Elem<kInF32> { using T = float; };
template <> struct Elem<kInF16> { using T = __half; };
template <> struct Elem<kInBF16> { using T = __nv_bfloat16; };
template <> struct Elem<kInI8> { using T = int8_t; };
template <> struct Elem<kInE4M3> { using T = __nv_fp8_storage_t; };
template <> struct Elem<kInE5M2> { using T = __nv_fp8_storage_t; };

template <int K>
__device__ __forceinline__ float decode(typename Elem<K>::T v) {
  if constexpr (K == kInF32) {
    return v;
  } else if constexpr (K == kInF16) {
    return __half2float(v);
  } else if constexpr (K == kInBF16) {
    return __bfloat162float(v);
  } else {
    static_assert(K == kInE4M3 || K == kInE5M2, "no float decode");
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        v, K == kInE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(h));
  }
}

// max(a, b) that propagates NaN: a when a is NaN, b when b is.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The accumulator of (input kind K, reduction R): uint32 for int8 sums
// (wrapping), f32 otherwise.
template <int K, int R>
struct Acc {
  using A = std::conditional_t<K == kInI8, uint32_t, float>;
  using T = typename Elem<K>::T;
  static __device__ __forceinline__ A identity() {
    if constexpr (R == kMax) return -INFINITY;
    return A(0);
  }
  static __device__ __forceinline__ A combine(A a, A b) {
    if constexpr (R == kMax) return nanmax(a, b);
    return a + b;
  }
  static __device__ __forceinline__ A step(A acc, T x, T y) {
    if constexpr (K == kInI8) {
      return acc + static_cast<uint32_t>(static_cast<int32_t>(x));
    } else if constexpr (R == kSum) {
      return acc + decode<K>(x);
    } else if constexpr (R == kMax) {
      return nanmax(acc, decode<K>(x));
    } else {
      return fmaf(decode<K>(x), decode<K>(y), acc);
    }
  }
};

// The CTA's combined value in thread 0: warp shuffles, then the warps'
// values in warp order.
template <class P>
__device__ __forceinline__ typename P::A block_reduce(typename P::A v) {
  __shared__ typename P::A red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = P::combine(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      v = P::combine(v, red[w]);
  return v;
}

template <int K, int R, int VEC, int LB>
__global__ void __launch_bounds__(kThreads)
    pass1(const typename Elem<K>::T* __restrict__ x,
          const typename Elem<K>::T* __restrict__ y, long long n,
          long long head, long long nvec,
          typename Acc<K, R>::A* __restrict__ partials) {
  using P = Acc<K, R>;
  using T = typename Elem<K>::T;
  typename P::A acc = P::identity();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll 4
  for (long long i = tid; i < nvec; i += stride) {
    const long long e = head + i * VEC;
    T a[VEC], b[VEC];
    load_raw<T, VEC, LB>(x + e, a);
    if constexpr (R == kDot) load_raw<T, VEC, LB>(y + e, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      acc = P::step(acc, a[j], R == kDot ? b[j] : a[j]);
  }
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x, tail = head + nvec * VEC;
    if (t < head) acc = P::step(acc, x[t], R == kDot ? y[t] : x[t]);
    if (tail + t < n)
      acc = P::step(acc, x[tail + t], R == kDot ? y[tail + t] : x[tail + t]);
  }
  acc = block_reduce<P>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <int K, int R>
__global__ void __launch_bounds__(kThreads)
    pass2(const typename Acc<K, R>::A* __restrict__ partials, int g,
          void* __restrict__ out, int out_dtype) {
  using P = Acc<K, R>;
  typename P::A acc = P::identity();
  for (int i = threadIdx.x; i < g; i += blockDim.x)
    acc = P::combine(acc, partials[i]);
  acc = block_reduce<P>(acc);
  if (threadIdx.x == 0) {
    if constexpr (K == kInI8)
      *static_cast<int32_t*>(out) = static_cast<int32_t>(acc);
    else
      store_any(out, out_dtype, 0, acc);
  }
}

template <int K, int R, int VEC, int LB>
cudaError_t run(const void* x, const void* y, long long n, void* partials,
                void* out, int out_dtype, cudaStream_t stream) {
  using T = typename Elem<K>::T;
  using A = typename Acc<K, R>::A;
  const Split s = split_flat(x, n, sizeof(T), VEC, LB);
  long long ctas = (s.nvec + kThreads * kStepsPerThread - 1) /
                   (kThreads * kStepsPerThread);
  ctas = ctas < 1 ? 1 : (ctas > kMaxPartials ? kMaxPartials : ctas);
  pass1<K, R, VEC, LB><<<static_cast<int>(ctas), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), n, s.head, s.nvec,
      static_cast<A*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pass2<K, R><<<1, kThreads, 0, stream>>>(static_cast<const A*>(partials),
                                          static_cast<int>(ctas), out,
                                          out_dtype);
  return cudaGetLastError();
}

// The rungs: ``vec`` elements a thread in loads of min(16, vec * size)
// bytes, or the unpacked 8-wide rung's 4-byte loads (ops/rowwise.py
// load_bytes); 16 elements only for 1-byte inputs (one 16-byte load).
template <int K, int R>
cudaError_t by_rung(const void* x, const void* y, long long n, int vec,
                    int lb, void* partials, void* out, int out_dtype,
                    cudaStream_t stream) {
  constexpr int S = sizeof(typename Elem<K>::T);
  constexpr int L2 = 2 * S < 16 ? 2 * S : 16;
  constexpr int L4 = 4 * S < 16 ? 4 * S : 16;
  constexpr int L8 = 8 * S < 16 ? 8 * S : 16;
#define LC_RUN(V, L) run<K, R, V, L>(x, y, n, partials, out, out_dtype, stream)
  if (vec == 1 && lb == S) return LC_RUN(1, S);
  if (vec == 2 && lb == L2) return LC_RUN(2, L2);
  if (vec == 4 && lb == L4) return LC_RUN(4, L4);
  if (vec == 8 && lb == L8) return LC_RUN(8, L8);
  if (vec == 8 && lb == 4) return LC_RUN(8, 4);
  if constexpr (S == 1)
    if (vec == 16 && lb == 16) return LC_RUN(16, 16);
#undef LC_RUN
  return cudaErrorInvalidValue;
}

template <int R>
cudaError_t by_kind(const void* x, const void* y, long long n, int in_dtype,
                    int vec, int lb, void* partials, void* out, int out_dtype,
                    cudaStream_t stream) {
#define LC_KIND(K)                                                      \
  case K:                                                               \
    return by_rung<K, R>(x, y, n, vec, lb, partials, out, out_dtype, \
                         stream)
  switch (in_dtype) {
    LC_KIND(kInF32);
    LC_KIND(kInF16);
    LC_KIND(kInBF16);
  }
  if constexpr (R == kSum) {
    switch (in_dtype) {
      LC_KIND(kInI8);
      LC_KIND(kInE4M3);
      LC_KIND(kInE5M2);
    }
  }
#undef LC_KIND
  return cudaErrorInvalidValue;
}

}  // namespace

// One value from the n elements of contiguous x (and y, for the dot) of
// dtype ``in_dtype`` (0 f32, 1 f16, 2 bf16, 3 int8, 4 e4m3, 5 e5m2; the max
// and the dot take the first three): ``op`` 0 the sum, 1 the max, 2 the dot
// product, written to ``out`` in ``out_dtype`` (0 f32, 1 f16, 2 bf16; the
// int8 sum: 6, int32). ``partials`` holds kMaxPartials 4-byte values of
// scratch; ``vec`` / ``load_bytes`` are the rung.
extern "C" int lc_reduce(const void* x, const void* y, long long n,
                         int in_dtype, int op, int vec, int load_bytes,
                         void* partials, void* out, int out_dtype,
                         void* stream) {
  if (n < 0 || (in_dtype == kInI8) != (out_dtype == kOutI32) ||
      (out_dtype != kOutI32 && (out_dtype < kF32 || out_dtype > kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (op == kSum)
    err = by_kind<kSum>(x, y, n, in_dtype, vec, load_bytes, partials, out,
                        out_dtype, s);
  else if (op == kMax)
    err = by_kind<kMax>(x, y, n, in_dtype, vec, load_bytes, partials, out,
                        out_dtype, s);
  else if (op == kDot)
    err = by_kind<kDot>(x, y, n, in_dtype, vec, load_bytes, partials, out,
                        out_dtype, s);
  return static_cast<int>(err);
}
