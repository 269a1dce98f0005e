// Interleaved-pair RoPE for Hopper on x (S, D), position = row:
//   out[s, 2i]     = x[s, 2i] cos(s f_i) - x[s, 2i + 1] sin(s f_i)
//   out[s, 2i + 1] = x[s, 2i] sin(s f_i) + x[s, 2i + 1] cos(s f_i)
// computed in f32 and rounded to x's dtype (f32, f16 or bf16).
//
// Replaces: leetcuda_tpu/ops/rope.py make_rope (_rope_pair_kernel) and
// make_rope_lane (_rope_lane_kernel): one function on two TPU layouts (the
// de-interleaved planes, the native lanes), one kernel here.
//
// Bound on an H100 SXM: bytes. x is read once and out written once ((65536,
// 128) f32: 67 MB, 20 us at 3.35 TB/s); a pair costs one sincosf and six
// flops. Design: the frequencies f_i come from a (D / 2,) f32 table that the
// wrapper builds once with the plain version's formula (theta^(-i / half));
// the TPU kernels' exp(i * -ln(theta) / half) differs from it by up to
// 5.5e-7 relative in f32, which the angle s f_i multiplies by the position
// (1.1e-4 at s = 2048, 1.9e-3 at 32768). s f_i is then the same f32 product
// here and in the plain version, and sincosf is the accurate one (this
// source builds without --use_fast_math; __sincosf loses accuracy far from
// +-pi). A thread rotates P consecutive pairs of one row: the rung (f32: 1
// pair, f32_v2: 2, f32x4_pack: 2 in one 4-element word, 16 bytes in f32).
// A packed word is one load and one store only where it is aligned and
// whole; else the pairs go an element at a time (D % 4 != 0, a row off the
// word's alignment, the last pair of an odd D / 2). Out of place: x is
// never written (the lane kernel's input_output_aliases is a TPU
// workaround).
#include <stdint.h>

#include "dtype.cuh"

namespace {

using namespace lc;  // dtype codes and conversions (dtype.cuh)

constexpr int kThreads = 256;

template <int B>
struct Bytes;
template <>
struct Bytes<4> { using type = uint32_t; };
template <>
struct Bytes<8> { using type = uint2; };
template <>
struct Bytes<16> { using type = uint4; };

template <class T, int P, bool PACK>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ x, const float* __restrict__ inv_freq,
            T* __restrict__ out, long long S, int D) {
  constexpr int E = 2 * P;  // elements of a thread
  using W = typename Bytes<E * sizeof(T)>::type;
  const int half = D / 2, groups = (half + P - 1) / P;
  const long long g = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (g >= S * groups) return;
  const long long row = g / groups;
  const int p0 = static_cast<int>(g % groups) * P;
  const int np = min(P, half - p0);
  const size_t off = (size_t)row * D + 2 * p0;
  const bool word = PACK && np == P &&
                    reinterpret_cast<uintptr_t>(x + off) % sizeof(W) == 0 &&
                    reinterpret_cast<uintptr_t>(out + off) % sizeof(W) == 0;
  alignas(16) T v[E];
  if (word) {
    *reinterpret_cast<W*>(v) = *reinterpret_cast<const W*>(x + off);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = e < 2 * np ? x[off + e] : T(0);
  }
  const float pos = static_cast<float>(row);
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p >= np) break;
    float s, c;
    sincosf(pos * inv_freq[p0 + p], &s, &c);
    const float x1 = to_f32(v[2 * p]), x2 = to_f32(v[2 * p + 1]);
    v[2 * p] = from_f32<T>(x1 * c - x2 * s);
    v[2 * p + 1] = from_f32<T>(x1 * s + x2 * c);
  }
  if (word) {
    *reinterpret_cast<W*>(out + off) = *reinterpret_cast<const W*>(v);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < 2 * np) out[off + e] = v[e];
  }
}

template <class T>
int launch(int pairs, int pack, const void* x, const float* inv_freq,
           void* out, long long S, int D, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int half = D / 2;
  const long long threads = S * ((half + pairs - 1) / pairs);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (pairs == 1 && !pack)
    rope_kernel<T, 1, false><<<nb, kThreads, 0, st>>>(xt, inv_freq, ot, S, D);
  else if (pairs == 1)
    rope_kernel<T, 1, true><<<nb, kThreads, 0, st>>>(xt, inv_freq, ot, S, D);
  else if (pairs == 2 && !pack)
    rope_kernel<T, 2, false><<<nb, kThreads, 0, st>>>(xt, inv_freq, ot, S, D);
  else if (pairs == 2)
    rope_kernel<T, 2, true><<<nb, kThreads, 0, st>>>(xt, inv_freq, ot, S, D);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (S, D) = RoPE of x (S, D) with the frequencies ``inv_freq`` (D / 2,
// f32); ``dtype`` is x's and out's (0 f32, 1 f16, 2 bf16), ``pairs`` (1 or
// 2) the pairs a thread rotates, ``pack`` their one-word load. Needs S > 0,
// an even D > 0 and contiguous x, inv_freq and out. Returns
// cudaGetLastError() after the launch (0 = launched) on ``stream``; does
// not synchronise and allocates nothing.
extern "C" int lc_rope(const void* x, const float* inv_freq, void* out,
                       long long S, int D, int dtype, int pairs, int pack,
                       void* stream) {
  if (S <= 0 || D <= 0 || D % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch<float>(pairs, pack, x, inv_freq, out, S, D, st);
    case kF16:
      return launch<__half>(pairs, pack, x, inv_freq, out, S, D, st);
    case kBF16:
      return launch<__nv_bfloat16>(pairs, pack, x, inv_freq, out, S, D, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
