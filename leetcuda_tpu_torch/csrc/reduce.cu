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
// 2048) f32 sum: 134 MB, 40 us at 3.35 TB/s; int8 or e4m3: 10 us). The TPU
// kernels carry their accumulator from one sequential grid step to the
// next; here CTAs run in parallel and in no order. One launch, no float
// atomics:
// - ``grid`` CTAs (ops/reduce.py reduce_plan: kCtasPerSm an SM, fewer for a
//   small array) walk the array's whole vectors grid-stride, VEC elements a
//   thread a vector (the rung of the JAX ladder) in loads of LB bytes. A
//   thread issues U vectors' loads (kInflight loads, kMaxBytes bytes at
//   most) before it adds any: a registered rung may load one byte at a
//   time, and one load in flight a thread left the card waiting on memory.
//   The elements before the first LB-aligned address and after the last
//   whole vector go one at a time to CTA 0. The sum's and the max's loads
//   are evict-first (ld.global.cs): x is read once, and its lines then
//   leave the L2 before lines that other kernels left there, dirty ones
//   included, whose write-back would otherwise share the memory bus with
//   the read (0.0360 -> 0.0271 ms for the int8 sum, bench --reduce). The
//   dot keeps plain loads, which ran 2-3% faster for it.
// - A thread adds its elements in order into one accumulator; a CTA
//   reduces its threads' values by warp shuffles, then its warps' in warp
//   order, and writes one partial to its slot of the per-stream scratch.
//   It then raises the scratch's counter; the CTA that finds itself last
//   adds the slots in slot order the same way, writes the result and sets
//   the counter back to 0 for the next launch on the stream. The order of
//   every operation depends only on n, the rung, x's alignment and the
//   grid, so a result is the same bits on every run (and in every replay
//   of a captured graph).
// - Float inputs are decoded to f32: f16 / bf16 by their converts, e4m3
//   and e5m2 two at a time by the paired hardware cvt (cvt.rn.f16x2.e4m3x2;
//   one at a time on the one-byte rung; bytes 0x7F and 0xFF of e4m3 are
//   NaN), and accumulate in f32; the result is rounded once to the
//   accumulator's type (the f16 and bf16 accumulators of the ladder hold
//   an f32 sum rounded once, which is what the TPU computed for them:
//   reduce.py _kernel_acc_dtype). int8 sums accumulate in uint32, four
//   bytes a dp4a where a load holds whole words, wrapping mod 2^32 as
//   JAX's int32 sum does, and are written as int32. The max propagates NaN
//   (fmaxf would drop it) and is -inf over no element.
// bench/gemm_bench.py --reduce builds the variants: LC_REDUCE_CTAS_PER_SM,
// LC_REDUCE_INFLIGHT, LC_REDUCE_LAUNCHES 2 (the slots added by a second
// launch of one CTA), LC_REDUCE_CS 0 (plain loads) and a probe that
// computes nothing right (LC_REDUCE_PROBE 1: the loads alone, each folded
// into one XOR).
#include <cuda_fp8.h>

#include <type_traits>

#include "dtype.cuh"
#include "vec_io.cuh"

#ifndef LC_REDUCE_CTAS_PER_SM
#define LC_REDUCE_CTAS_PER_SM 4
#endif
#ifndef LC_REDUCE_INFLIGHT
#define LC_REDUCE_INFLIGHT 16
#endif
#ifndef LC_REDUCE_LAUNCHES
#define LC_REDUCE_LAUNCHES 1
#endif
#ifndef LC_REDUCE_PROBE
#define LC_REDUCE_PROBE 0
#endif
#ifndef LC_REDUCE_CS
#define LC_REDUCE_CS 1  // the sum's and the max's loads evict-first
#endif

namespace {

using namespace lc;

enum In { kInF32 = 0, kInF16 = 1, kInBF16 = 2, kInI8 = 3, kInE4M3 = 4,
          kInE5M2 = 5 };
constexpr int kOutI32 = 6;
enum Red { kSum = 0, kMax = 1, kDot = 2 };
constexpr int kThreads = 256;
constexpr int kCtasPerSm = LC_REDUCE_CTAS_PER_SM;
constexpr int kInflight = LC_REDUCE_INFLIGHT;  // loads a thread has issued
constexpr int kMaxBytes = 64;   // bytes a thread holds in flight at most
// the scratch (ops/reduce.py SCRATCH_INTS): the counter, padded to a
// 128-byte line, then one 4-byte slot a CTA
constexpr int kHeaderInts = 32;
constexpr int kMaxSlots = 2048;
constexpr bool kOneLaunch = LC_REDUCE_LAUNCHES == 1;

// vectors a thread loads before it adds: kInflight loads of LB bytes and
// kMaxBytes at most, at least one vector (ops/reduce.py vectors_in_flight)
template <int S, int VEC, int LB>
__host__ __device__ constexpr int vectors_in_flight() {
  constexpr int loads = VEC * S / LB, bytes = VEC * S;
  constexpr int u = kInflight / loads < kMaxBytes / bytes ? kInflight / loads
                                                          : kMaxBytes / bytes;
  return u < 1 ? 1 : u;
}

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

// Two fp8 values (the low byte first) as two floats, by one paired cvt.
template <int K>
__device__ __forceinline__ float2 decode2(uint32_t pair) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair),
      K == kInE4M3 ? __NV_E4M3 : __NV_E5M2);
  return __half22float2(__half2(h));
}

// max(a, b) that propagates NaN: a when a is NaN, b when b is.
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The 32-bit word i of a load unit of LB >= 4 bytes.
template <int LB>
__device__ __forceinline__ uint32_t word(const typename Word<LB>::type& u,
                                         int i) {
  if constexpr (LB == 4) {
    return u;
  } else if constexpr (LB == 8) {
    return i == 0 ? u.x : u.y;
  } else {
    return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
  }
}

// VEC elements as VEC * S / LB load units of LB bytes.
template <class T, int VEC, int LB>
struct Vec {
  using U = typename Word<LB>::type;
  static constexpr int N = VEC * static_cast<int>(sizeof(T)) / LB;
  U u[N];
  template <bool kCs>
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if constexpr (kCs)
        u[i] = __ldcs(reinterpret_cast<const U*>(p) + i);
      else
        u[i] = reinterpret_cast<const U*>(p)[i];
    }
  }
  __device__ __forceinline__ T at(int j) const {
    constexpr int PER = LB / static_cast<int>(sizeof(T));
    return reinterpret_cast<const T*>(&u[j / PER])[j % PER];
  }
};

// The accumulator of (input kind K, reduction R): uint32 for int8 sums
// (wrapping), f32 otherwise; ``add`` folds one vector in, in element order.
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
  template <int VEC, int LB>
  static __device__ __forceinline__ A add(A acc, const Vec<T, VEC, LB>& v,
                                          const T (&y)[VEC]) {
    constexpr bool kBytes = K == kInI8 || K == kInE4M3 || K == kInE5M2;
    if constexpr (LC_REDUCE_PROBE == 1) {
      uint32_t sink = 0;  // the loads alone
#pragma unroll
      for (int i = 0; i < v.N; ++i)
        sink ^= *reinterpret_cast<const uint8_t*>(&v.u[i]);
      return acc + A(sink & 1u);
    } else if constexpr (K == kInI8 && LB >= 4) {
#pragma unroll
      for (int i = 0; i < v.N; ++i)
#pragma unroll
        for (int w = 0; w < LB / 4; ++w)
          acc = static_cast<uint32_t>(__dp4a(
              static_cast<int>(word<LB>(v.u[i], w)), 0x01010101,
              static_cast<int>(acc)));
      return acc;
    } else if constexpr (kBytes && K != kInI8 && LB >= 4) {
#pragma unroll
      for (int i = 0; i < v.N; ++i)
#pragma unroll
        for (int w = 0; w < LB / 4; ++w) {
          const uint32_t x = word<LB>(v.u[i], w);
          const float2 lo = decode2<K>(x & 0xffffu);
          const float2 hi = decode2<K>(x >> 16);
          acc = acc + lo.x;
          acc = acc + lo.y;
          acc = acc + hi.x;
          acc = acc + hi.y;
        }
      return acc;
    } else if constexpr (kBytes && K != kInI8 && LB == 2) {
#pragma unroll
      for (int i = 0; i < v.N; ++i) {
        const float2 p = decode2<K>(v.u[i]);
        acc = acc + p.x;
        acc = acc + p.y;
      }
      return acc;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc = step(acc, v.at(j), y[j]);
      return acc;
    }
  }
};

// The CTA's combined value in thread 0: warp shuffles (xor 16, 8, 4, 2, 1),
// then the warps' values in warp order.
template <class P>
__device__ __forceinline__ typename P::A block_reduce(typename P::A v) {
  __shared__ typename P::A red[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = P::combine(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kThreads / 32; ++w) v = P::combine(v, red[w]);
  return v;
}

// The ``g`` slots added in slot order (thread t takes t, t + kThreads, ...,
// then block_reduce), the result written in the accumulator's type.
template <class P>
__device__ __forceinline__ void add_slots(const typename P::A* slots, int g,
                                          void* out, int out_dtype) {
  using A = typename P::A;
  A v = P::identity();
  for (int i = threadIdx.x; i < g; i += kThreads)
    v = P::combine(v, __ldcg(slots + i));
  v = block_reduce<P>(v);
  if (threadIdx.x == 0) {
    if constexpr (std::is_same_v<A, uint32_t>)
      *static_cast<int32_t*>(out) = static_cast<int32_t>(v);
    else
      store_any(out, out_dtype, 0, v);
  }
}

// kCtasPerSm CTAs an SM held at once (64 registers a thread at 4), so that
// the grid runs in one wave.
template <int K, int R, int VEC, int LB>
__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    reduce_flat(const typename Elem<K>::T* __restrict__ x,
                const typename Elem<K>::T* __restrict__ y, long long n,
                long long head, long long nvec,
                typename Acc<K, R>::A* __restrict__ slots,
                unsigned int* __restrict__ counter, void* __restrict__ out,
                int out_dtype) {
  using P = Acc<K, R>;
  using T = typename Elem<K>::T;
  constexpr int S = sizeof(T);
  constexpr int U = vectors_in_flight<S, VEC, LB>();
  constexpr bool kCs = LC_REDUCE_CS && R != kDot;
  typename P::A acc = P::identity();
  const long long g =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long whole = nvec / (U * stride) * (U * stride);
  const T* xv = x + head;
  const T* yv = y + head;
  T b[VEC] = {};
  for (long long base = 0; base < whole; base += U * stride) {
    Vec<T, VEC, LB> v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u].template load<kCs>(xv + (base + u * stride + g) * VEC);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (R == kDot)
        load_raw<T, VEC, LB>(yv + (base + u * stride + g) * VEC, b);
      acc = P::template add<VEC, LB>(acc, v[u], b);
    }
  }
  for (long long i = whole + g; i < nvec; i += stride) {
    Vec<T, VEC, LB> v;
    v.template load<kCs>(xv + i * VEC);
    if constexpr (R == kDot) load_raw<T, VEC, LB>(yv + i * VEC, b);
    acc = P::template add<VEC, LB>(acc, v, b);
  }
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x, tail = head + nvec * VEC;
    if (t < head) acc = P::step(acc, x[t], R == kDot ? y[t] : x[t]);
    if (tail + t < n)
      acc = P::step(acc, x[tail + t], R == kDot ? y[tail + t] : x[tail + t]);
  }
  acc = block_reduce<P>(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    slots[blockIdx.x] = acc;
    if constexpr (kOneLaunch) {
      __threadfence();  // the slot before the count
      last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
  }
  if constexpr (kOneLaunch) {
    __syncthreads();
    if (!last) return;
    __threadfence();  // every CTA's slot, seen through their counts
    add_slots<P>(slots, gridDim.x, out, out_dtype);
    if (threadIdx.x == 0) *counter = 0u;
  }
}

// LC_REDUCE_LAUNCHES 2: the slots added by a second launch of one CTA.
template <int K, int R>
__global__ void __launch_bounds__(kThreads)
    add_slots_kernel(const typename Acc<K, R>::A* __restrict__ slots, int g,
                     void* __restrict__ out, int out_dtype) {
  add_slots<Acc<K, R>>(slots, g, out, out_dtype);
}

template <int K, int R, int VEC, int LB>
cudaError_t run(const void* x, const void* y, long long n, void* scratch,
                void* out, int out_dtype, int grid, cudaStream_t stream) {
  using T = typename Elem<K>::T;
  using A = typename Acc<K, R>::A;
  const Split s = split_flat(x, n, sizeof(T), VEC, LB);
  auto* counter = static_cast<unsigned int*>(scratch);
  auto* slots = reinterpret_cast<A*>(static_cast<int*>(scratch) +
                                     kHeaderInts);
  reduce_flat<K, R, VEC, LB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), n, s.head, s.nvec,
      slots, counter, out, out_dtype);
  cudaError_t err = cudaGetLastError();
  if (kOneLaunch || err != cudaSuccess) return err;
  add_slots_kernel<K, R><<<1, kThreads, 0, stream>>>(slots, grid, out,
                                                     out_dtype);
  return cudaGetLastError();
}

// The rungs: ``vec`` elements a thread in loads of min(16, vec * size)
// bytes, or the unpacked 8-wide rung's 4-byte loads (ops/rowwise.py
// load_bytes); 16 elements only for 1-byte inputs (one 16-byte load).
template <int K, int R>
cudaError_t by_rung(const void* x, const void* y, long long n, int vec,
                    int lb, void* scratch, void* out, int out_dtype, int grid,
                    cudaStream_t stream) {
  constexpr int S = sizeof(typename Elem<K>::T);
  constexpr int L2 = 2 * S < 16 ? 2 * S : 16;
  constexpr int L4 = 4 * S < 16 ? 4 * S : 16;
  constexpr int L8 = 8 * S < 16 ? 8 * S : 16;
#define LC_RUN(V, L) \
  run<K, R, V, L>(x, y, n, scratch, out, out_dtype, grid, stream)
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
                    int vec, int lb, void* scratch, void* out, int out_dtype,
                    int grid, cudaStream_t stream) {
#define LC_KIND(K)                                                      \
  case K:                                                               \
    return by_rung<K, R>(x, y, n, vec, lb, scratch, out, out_dtype, grid, \
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

// {threads, CTAs an SM, loads in flight, bytes in flight, scratch header
// ints, slots, launches, probe, evict-first loads} of the build.
extern "C" int lc_reduce_info(int* info) {
  const int v[9] = {kThreads,           kCtasPerSm,      kInflight,
                    kMaxBytes,          kHeaderInts,     kMaxSlots,
                    LC_REDUCE_LAUNCHES, LC_REDUCE_PROBE, LC_REDUCE_CS};
  for (int i = 0; i < 9; ++i) info[i] = v[i];
  return 0;
}

// One value from the n elements of contiguous x (and y, for the dot) of
// dtype ``in_dtype`` (0 f32, 1 f16, 2 bf16, 3 int8, 4 e4m3, 5 e5m2; the max
// and the dot take the first three): ``op`` 0 the sum, 1 the max, 2 the dot
// product, written to ``out`` in ``out_dtype`` (0 f32, 1 f16, 2 bf16; the
// int8 sum: 6, int32), by ``grid`` CTAs (1 to kMaxSlots). ``scratch`` is
// the stream's kHeaderInts + kMaxSlots ints, its counter 0 between
// launches (the last CTA sets it back); ``vec`` / ``load_bytes`` are the
// rung. Launches on ``stream``; allocates nothing. Returns the CUDA error.
extern "C" int lc_reduce(const void* x, const void* y, long long n,
                         int in_dtype, int op, int vec, int load_bytes,
                         void* scratch, void* out, int out_dtype, int grid,
                         void* stream) {
  if (n < 0 || grid < 1 || grid > kMaxSlots ||
      (in_dtype == kInI8) != (out_dtype == kOutI32) ||
      (out_dtype != kOutI32 && (out_dtype < kF32 || out_dtype > kBF16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (op == kSum)
    err = by_kind<kSum>(x, y, n, in_dtype, vec, load_bytes, scratch, out,
                        out_dtype, grid, s);
  else if (op == kMax)
    err = by_kind<kMax>(x, y, n, in_dtype, vec, load_bytes, scratch, out,
                        out_dtype, grid, s);
  else if (op == kDot)
    err = by_kind<kDot>(x, y, n, in_dtype, vec, load_bytes, scratch, out,
                        out_dtype, grid, s);
  return static_cast<int>(err);
}
