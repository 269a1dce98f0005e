// Elementwise maps for Hopper: the add and the seven activations of the op
// corpus over a flat contiguous (S, K) in f32, f16 or bf16.
//
// Replaces: leetcuda_tpu/ops/elementwise.py make_elementwise_binary
// (_binary_kernel) and ops/activations.py make_activation (_unary_kernel).
//
// Bound on an H100 SXM: bytes. The add reads two inputs and writes one
// output, an activation reads one and writes one, and each does a few
// operations an element (a (16384, 2048) bf16 add: 201 MB, 60 us at
// 3.35 TB/s). A thread takes VEC elements a vector, the rung of the JAX
// ladder (1, 2, 4 or 8), loaded LB bytes at a time: one 16-byte load for
// the "pack" rungs, 4 bytes (the reference's half2) for the unpacked 8-wide
// ones. Design (ops/elementwise.py map_plan sizes the grid): one pass over
// exactly the vectors in chunks of U x 256, a CTA a chunk, its thread t
// taking vectors t, t + 256, ... of it: U = LC_MAP_LOADS (4) vectors of one
// load each, or one vector of several (the f32 8-wide rungs', the unpacked
// ones'), every load issued (x and, for the add, y) before any math, then
// computed and stored. The elements before x's first LB-aligned address and
// after its last whole vector are taken one at a time by the
// first threads of the grid, and a y or an output that is not aligned with
// x is read or written element by element, so every rung takes any size and
// any base address. The math runs in f32 and is rounded once to the storage
// type, as _unary_kernel computes it: the add of two f16 or bf16 values in
// f32 and one rounding is the correctly rounded sum (f32 carries more than
// twice their precision, plus 2 bits), so it is exact. f32 outputs keep
// IEEE-accurate expf, tanhf and division; f16 and bf16 outputs, which round
// 2^-11 or 2^-8 away, take the SFU's forms: exp as ex2.approx (relative
// error ~2^-22), 1 / d as rcp.approx (~1 ulp, subnormal results kept), tanh
// as tanh.approx (~2^-11, and exactly +-1 at large |x| on the card, so that
// the gelu's (1 + tanh) of a large negative x is exactly 0, as in f32).
// max, min and the clamps propagate NaN, as jnp.maximum and
// jnp.clip do (fmaxf / fminf would drop it). f32 denormals are kept (nvcc's
// default), where XLA flushes them to zero: sigmoid(-88) is 6.05e-39 here
// and 0 in JAX, swish(-inf) -inf here and NaN (-inf * 0) there. The output
// is a new buffer: x is never written (the TPU kernels alias x to their
// output).
#include <type_traits>

#include "dtype.cuh"
#include "vec_io.cuh"

namespace {

using namespace lc;

enum Op {
  kAdd = 0,
  kRelu = 1,
  kSigmoid = 2,
  kGelu = 3,
  kSwish = 4,
  kElu = 5,
  kHardswish = 6,
  kHardshrink = 7,
};
#ifndef LC_MAP_LOADS
#define LC_MAP_LOADS 4  // loads of x a thread issues before its math
#endif
#ifndef LC_MAP_CS
#define LC_MAP_CS 0  // 1: whole words streamed (ld / st .cs; the bench's)
#endif
#ifndef LC_MAP_FAST
#define LC_MAP_FAST 1  // 0: IEEE math for f16 / bf16 outputs too (the bench)
#endif

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluCoef = 0.044715f;
constexpr float kExpClamp = 88.0f;  // the MIN/MAX_EXP_F32 analog

// clip(x, lo, hi) with NaN passed through (both compares are false).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// 2^x, 1 / x and tanh(x) on the SFU. 2^x flushes results below 2^-126 to
// zero, which changes no output here (every exp is added to 1 or has 1
// taken from it); 1 / x keeps subnormal results (no .ftz), so sigmoid at
// the clamp is 6.05e-39 and swish(-inf) is -inf, as in f32.
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp, 1 / d and tanh: IEEE-accurate, or (FAST) the SFU's forms.
template <bool FAST>
__device__ __forceinline__ float exp_(float x) {
  return FAST ? ex2_approx(x * kLog2e) : expf(x);
}
template <bool FAST>
__device__ __forceinline__ float recip(float d) {
  return FAST ? rcp_approx(d) : 1.f / d;
}
template <bool FAST>
__device__ __forceinline__ float tanh_(float x) {
  return FAST ? tanh_approx(x) : tanhf(x);
}

template <bool FAST>
__device__ __forceinline__ float sigmoid(float x) {
  return recip<FAST>(1.f + exp_<FAST>(-clip(x, -kExpClamp, kExpClamp)));
}

// The activations.py math functions, in f32, in their order of operations
// (FAST: exp, 1 / d and tanh on the SFU, for f16 and bf16 outputs).
template <int OP, bool FAST>
__device__ __forceinline__ float apply(float x, float y) {
  if constexpr (OP == kAdd) {
    return __fadd_rn(x, y);
  } else if constexpr (OP == kRelu) {
    return (x > 0.f || x != x) ? x : 0.f;
  } else if constexpr (OP == kSigmoid) {
    return sigmoid<FAST>(x);
  } else if constexpr (OP == kGelu) {
    const float inner = kSqrt2OverPi * (x + kGeluCoef * x * x * x);
    return 0.5f * x * (1.f + tanh_<FAST>(inner));
  } else if constexpr (OP == kSwish) {
    return x * sigmoid<FAST>(x);
  } else if constexpr (OP == kElu) {  // alpha 1; min(x, 0) is x here
    const float e = exp_<FAST>(x) - 1.f;  // taken always: a select, no branch
    return x > 0.f ? x : e;
  } else if constexpr (OP == kHardswish) {
    return x * clip(x + 3.f, 0.f, 6.f) * (1.f / 6.f);
  } else {  // kHardshrink, lambda 0.5: NaN fails the compare and maps to 0
    return fabsf(x) > 0.5f ? x : 0.f;
  }
}

// Vectors a thread takes a step: LC_MAP_LOADS where a vector is one load;
// one where it is several (the f32 8-wide rungs' and the unpacked ones'),
// whose sectors L1 must hold until the last of them.
template <class T, int VEC, int LB>
constexpr int kMapUnroll =
    VEC * static_cast<int>(sizeof(T)) == LB ? LC_MAP_LOADS : 1;

// SFU math where the output is f16 or bf16.
template <class T>
constexpr bool kFast = LC_MAP_FAST && sizeof(T) == 2;

template <class T, int OP>
__device__ __forceinline__ void map_one(const T* x, const T* y, T* out,
                                        long long i) {
  const float b = OP == kAdd ? to_f32(y[i]) : 0.f;
  out[i] = from_f32<T>(apply<OP, kFast<T>>(to_f32(x[i]), b));
}

// The VEC elements at p: whole words of LB bytes where AL says p is
// LB-aligned, else as load_raw / store_raw find it.
template <class T, int N, int LB, bool AL>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[N]) {
  constexpr int PER = LB / static_cast<int>(sizeof(T));
  if constexpr (AL && PER > 1 && N % PER == 0) {
    using U = typename Word<LB>::type;
#pragma unroll
    for (int i = 0; i < N / PER; ++i) {
      const U u = LC_MAP_CS ? __ldcs(reinterpret_cast<const U*>(p) + i)
                            : reinterpret_cast<const U*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) v[i * PER + j] = e[j];
    }
  } else {
    load_raw<T, N, LB>(p, v);
  }
}

template <class T, int N, int LB, bool AL>
__device__ __forceinline__ void store_vec(T* p, const T (&v)[N]) {
  constexpr int PER = LB / static_cast<int>(sizeof(T));
  if constexpr (AL && PER > 1 && N % PER == 0) {
    using U = typename Word<LB>::type;
#pragma unroll
    for (int i = 0; i < N / PER; ++i) {
      U u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int j = 0; j < PER; ++j) e[j] = v[i * PER + j];
      if constexpr (LC_MAP_CS)
        __stcs(reinterpret_cast<U*>(p) + i, u);
      else
        reinterpret_cast<U*>(p)[i] = u;
    }
  } else {
    store_raw<T, N, LB>(p, v);
  }
}

// grid (G,): the body's vectors (VEC elements at head + v VEC) in chunks
// of U kThreads (U = kMapUnroll); CTA c takes chunks c, c + G, ... (one:
// map_plan's G is the chunks), its thread t vectors t, t + kThreads, ...
// of a chunk, every load of the chunk
// issued before its math, so that a warp's loads are contiguous 512-byte
// runs and a chunk one contiguous span. The first threads of the grid also
// take the head's and the tail's single elements. x + head is LB-aligned
// (the split puts it there); where y (the add's; x otherwise) and out are
// too, a whole chunk runs with no check a vector, and only the last chunk
// tests which of its vectors exist.
template <class T, int OP, int VEC, int LB>
__global__ void __launch_bounds__(kThreads)
    map_kernel(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, long long n, long long head,
               long long nvec) {
  constexpr int U = kMapUnroll<T, VEC, LB>;
  constexpr long long kChunk = static_cast<long long>(U) * kThreads;
  auto chunk = [&](long long c, auto whole, auto aligned) {
    constexpr bool W = decltype(whole)::value, A = decltype(aligned)::value;
    const long long i = c * kChunk + threadIdx.x;
    T a[U][VEC], b[U][VEC];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = i + k * kThreads;
      if (W || v < nvec) {
        load_vec<T, VEC, LB, A>(x + head + v * VEC, a[k]);
        if constexpr (OP == kAdd)
          load_vec<T, VEC, LB, A>(y + head + v * VEC, b[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long v = i + k * kThreads;
      if (W || v < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          a[k][j] = from_f32<T>(apply<OP, kFast<T>>(
              to_f32(a[k][j]), OP == kAdd ? to_f32(b[k][j]) : 0.f));
        store_vec<T, VEC, LB, A>(out + head + v * VEC, a[k]);
      }
    }
  };
  // a loop, though map_plan's grid gives each CTA one chunk: without it
  // the kernel ran 1.7-2.0x slower at the f32 8-wide packed rungs and 4%
  // at bf16 swish on an H100
  const long long whole = nvec / kChunk, chunks = (nvec + kChunk - 1) / kChunk;
  const bool aligned = (reinterpret_cast<uintptr_t>(y + head) |
                        reinterpret_cast<uintptr_t>(out + head)) % LB == 0;
  long long c = blockIdx.x;
  if (aligned) {
    for (; c < whole; c += gridDim.x)
      chunk(c, std::true_type{}, std::true_type{});
    if (c < chunks) chunk(c, std::false_type{}, std::true_type{});
  } else {
    for (; c < chunks; c += gridDim.x)
      chunk(c, std::false_type{}, std::false_type{});
  }
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long tail = head + nvec * VEC;
  if (tid < head) map_one<T, OP>(x, y, out, tid);
  if (tail + tid < n) map_one<T, OP>(x, y, out, tail + tid);
}

struct MapCall {
  const void* x;
  const void* y;
  void* out;
  long long n;
  int grid;
  cudaStream_t stream;
};

template <class T, int OP, int VEC, int LB>
cudaError_t run(const MapCall& c) {
  const Split s = split_flat(c.x, c.n, sizeof(T), VEC, LB);
  map_kernel<T, OP, VEC, LB><<<c.grid, kThreads, 0, c.stream>>>(
      static_cast<const T*>(c.x), static_cast<const T*>(c.y),
      static_cast<T*>(c.out), c.n, s.head, s.nvec);
  return cudaGetLastError();
}

// The rungs: (elements a thread, bytes a load) as ops/rowwise.py load_bytes
// gives them for an element of sizeof(T) bytes.
template <class T, int OP>
cudaError_t by_rung(int vec, int lb, const MapCall& c) {
  constexpr int S = sizeof(T);
  constexpr int L4 = 4 * S < 16 ? 4 * S : 16;
  if (vec == 1 && lb == S) return run<T, OP, 1, S>(c);
  if (vec == 2 && lb == 2 * S) return run<T, OP, 2, 2 * S>(c);
  if (vec == 4 && lb == L4) return run<T, OP, 4, L4>(c);
  if (vec == 8 && lb == 4) return run<T, OP, 8, 4>(c);
  if (vec == 8 && lb == 16) return run<T, OP, 8, 16>(c);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t by_op(int op, int vec, int lb, const MapCall& c) {
  switch (op) {
    case kAdd: return by_rung<T, kAdd>(vec, lb, c);
    case kRelu: return by_rung<T, kRelu>(vec, lb, c);
    case kSigmoid: return by_rung<T, kSigmoid>(vec, lb, c);
    case kGelu: return by_rung<T, kGelu>(vec, lb, c);
    case kSwish: return by_rung<T, kSwish>(vec, lb, c);
    case kElu: return by_rung<T, kElu>(vec, lb, c);
    case kHardswish: return by_rung<T, kHardswish>(vec, lb, c);
    case kHardshrink: return by_rung<T, kHardshrink>(vec, lb, c);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out[i] = op(x[i], y[i]) (the add) or op(x[i]) (an activation, y unused)
// for the n elements of contiguous x, y and out of dtype ``dtype`` (0 f32,
// 1 f16, 2 bf16); ``op`` an Op, ``vec`` / ``load_bytes`` the rung, ``grid``
// the CTAs of kThreads, a chunk each (ops/elementwise.py map_plan).
extern "C" int lc_elementwise(const void* x, const void* y, void* out,
                              long long n, int dtype, int op, int vec,
                              int load_bytes, int grid, void* stream) {
  if (n <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const MapCall c{x, y, out, n, grid, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == kF32)
    err = by_op<float>(op, vec, load_bytes, c);
  else if (dtype == kF16)
    err = by_op<__half>(op, vec, load_bytes, c);
  else if (dtype == kBF16)
    err = by_op<__nv_bfloat16>(op, vec, load_bytes, c);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
