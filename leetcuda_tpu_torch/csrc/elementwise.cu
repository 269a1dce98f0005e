// Elementwise maps for Hopper: the add and the seven activations of the op
// corpus over a flat contiguous (S, K) in f32, f16 or bf16.
//
// Replaces: leetcuda_tpu/ops/elementwise.py make_elementwise_binary
// (_binary_kernel) and ops/activations.py make_activation (_unary_kernel).
//
// Bound on an H100 SXM: bytes. The add reads two inputs and writes one
// output, an activation reads one and writes one, and each does a few
// operations an element (a (16384, 2048) bf16 add: 201 MB, 60 us at
// 3.35 TB/s). Design, simple first: a grid-stride loop in which a thread
// takes VEC elements a step, the rung of the JAX ladder (1, 2, 4 or 8),
// loaded LB bytes at a time: one 16-byte load for the "pack" rungs, 4 bytes
// (the reference's half2) for the unpacked 8-wide ones. The elements before
// x's first LB-aligned address and after its last whole vector are taken
// one at a time by the first threads of the grid, and a y or an output that
// is not aligned with x is read or written element by element, so every
// rung takes any size and any base address. The math runs in f32 and is
// rounded once to the storage type, as _unary_kernel computes it: the add
// of two f16 or bf16 values in f32 and one rounding is the correctly rounded
// sum (f32 carries more than twice their precision, plus 2 bits), so it is
// exact. max, min and the clamps propagate NaN, as jnp.maximum and jnp.clip
// do (fmaxf / fminf would drop it). f32 denormals are kept (nvcc's default),
// where XLA flushes them to zero: sigmoid(-88) is 6.05e-39 here and 0 in
// JAX, swish(-inf) -inf here and NaN (-inf * 0) there. The output is a new
// buffer: x is never written (the TPU kernels alias x to their output).
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
constexpr int kThreads = 256;
constexpr int kMaxCtas = 8192;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluCoef = 0.044715f;
constexpr float kExpClamp = 88.0f;  // the MIN/MAX_EXP_F32 analog

// clip(x, lo, hi) with NaN passed through (both compares are false).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-clip(x, -kExpClamp, kExpClamp)));
}

// The activations.py math functions, in f32, in their order of operations.
template <int OP>
__device__ __forceinline__ float apply(float x, float y) {
  if constexpr (OP == kAdd) {
    return __fadd_rn(x, y);
  } else if constexpr (OP == kRelu) {
    return (x > 0.f || x != x) ? x : 0.f;
  } else if constexpr (OP == kSigmoid) {
    return sigmoid(x);
  } else if constexpr (OP == kGelu) {
    const float inner = kSqrt2OverPi * (x + kGeluCoef * x * x * x);
    return 0.5f * x * (1.f + tanhf(inner));
  } else if constexpr (OP == kSwish) {
    return x * sigmoid(x);
  } else if constexpr (OP == kElu) {  // alpha 1; min(x, 0) is x here
    return x > 0.f ? x : expf(x) - 1.f;
  } else if constexpr (OP == kHardswish) {
    return x * clip(x + 3.f, 0.f, 6.f) * (1.f / 6.f);
  } else {  // kHardshrink, lambda 0.5: NaN fails the compare and maps to 0
    return fabsf(x) > 0.5f ? x : 0.f;
  }
}

template <class T, int OP>
__device__ __forceinline__ void map_one(const T* x, const T* y, T* out,
                                        long long i) {
  const float b = OP == kAdd ? to_f32(y[i]) : 0.f;
  out[i] = from_f32<T>(apply<OP>(to_f32(x[i]), b));
}

template <class T, int OP, int VEC, int LB>
__global__ void __launch_bounds__(kThreads)
    map_kernel(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, long long n, long long head,
               long long nvec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < nvec; i += stride) {
    const long long e = head + i * VEC;
    T a[VEC], b[VEC];
    float r[VEC];
    load_raw<T, VEC, LB>(x + e, a);
    if constexpr (OP == kAdd) load_raw<T, VEC, LB>(y + e, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      r[j] = apply<OP>(to_f32(a[j]), OP == kAdd ? to_f32(b[j]) : 0.f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = from_f32<T>(r[j]);
    store_raw<T, VEC, LB>(out + e, a);
  }
  const long long tail = head + nvec * VEC;
  if (tid < head) map_one<T, OP>(x, y, out, tid);
  if (tail + tid < n) map_one<T, OP>(x, y, out, tail + tid);
}

template <class T, int OP, int VEC, int LB>
cudaError_t run(const void* x, const void* y, void* out, long long n,
                cudaStream_t stream) {
  const Split s = split_flat(x, n, sizeof(T), VEC, LB);
  long long ctas = (s.nvec + kThreads - 1) / kThreads;
  ctas = ctas < 1 ? 1 : (ctas > kMaxCtas ? kMaxCtas : ctas);
  map_kernel<T, OP, VEC, LB><<<static_cast<int>(ctas), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out),
      n, s.head, s.nvec);
  return cudaGetLastError();
}

// The rungs: (elements a thread, bytes a load) as ops/rowwise.py load_bytes
// gives them for an element of sizeof(T) bytes.
template <class T, int OP>
cudaError_t by_rung(const void* x, const void* y, void* out, long long n,
                    int vec, int lb, cudaStream_t stream) {
  constexpr int S = sizeof(T);
  constexpr int L4 = 4 * S < 16 ? 4 * S : 16;
  if (vec == 1 && lb == S) return run<T, OP, 1, S>(x, y, out, n, stream);
  if (vec == 2 && lb == 2 * S) return run<T, OP, 2, 2 * S>(x, y, out, n, stream);
  if (vec == 4 && lb == L4) return run<T, OP, 4, L4>(x, y, out, n, stream);
  if (vec == 8 && lb == 4) return run<T, OP, 8, 4>(x, y, out, n, stream);
  if (vec == 8 && lb == 16) return run<T, OP, 8, 16>(x, y, out, n, stream);
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t by_op(const void* x, const void* y, void* out, long long n, int op,
                  int vec, int lb, cudaStream_t stream) {
  switch (op) {
    case kAdd: return by_rung<T, kAdd>(x, y, out, n, vec, lb, stream);
    case kRelu: return by_rung<T, kRelu>(x, y, out, n, vec, lb, stream);
    case kSigmoid: return by_rung<T, kSigmoid>(x, y, out, n, vec, lb, stream);
    case kGelu: return by_rung<T, kGelu>(x, y, out, n, vec, lb, stream);
    case kSwish: return by_rung<T, kSwish>(x, y, out, n, vec, lb, stream);
    case kElu: return by_rung<T, kElu>(x, y, out, n, vec, lb, stream);
    case kHardswish:
      return by_rung<T, kHardswish>(x, y, out, n, vec, lb, stream);
    case kHardshrink:
      return by_rung<T, kHardshrink>(x, y, out, n, vec, lb, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// out[i] = op(x[i], y[i]) (the add) or op(x[i]) (an activation, y unused)
// for the n elements of contiguous x, y and out of dtype ``dtype`` (0 f32,
// 1 f16, 2 bf16); ``op`` an Op, ``vec`` / ``load_bytes`` the rung.
extern "C" int lc_elementwise(const void* x, const void* y, void* out,
                              long long n, int dtype, int op, int vec,
                              int load_bytes, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = by_op<float>(x, y, out, n, op, vec, load_bytes, s);
  else if (dtype == kF16)
    err = by_op<__half>(x, y, out, n, op, vec, load_bytes, s);
  else if (dtype == kBF16)
    err = by_op<__nv_bfloat16>(x, y, out, n, op, vec, load_bytes, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
