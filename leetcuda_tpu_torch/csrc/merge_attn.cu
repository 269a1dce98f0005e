// merge_attn_states for Hopper: the LSE-weighted merge of two normalised
// partial attention outputs over disjoint key ranges (the combine pass of
// split-KV attention):
//   m = max(lse_p, lse_s), wp = exp(lse_p - m), ws = exp(lse_s - m)
//   out = (wp * out_p + ws * out_s) / (wp + ws), lse = m + log(wp + ws)
// A non-finite lse (an empty split) is weight 0: it is taken as -1e30, so two
// empty sides give the average of the two and an lse of -1e30.
//
// Replaces: leetcuda_tpu/ops/merge_attn_states.py make_merge_attn_states
// (_merge_kernel).
//
// Bound on an H100 SXM: bytes. Two outputs are read and one written (T =
// 2048, H = 16, D = 128 in bf16: 25 MB, 7.5 us at 3.35 TB/s); a few
// operations an element. Design: one thread per (t, h, 16 bytes of d),
// consecutive threads on consecutive chunks of a row; each thread computes
// its row's weights from the two lse values (read by every chunk of the
// row, from L1) and the first chunk writes the merged lse. A chunk that is
// not 16-byte aligned in all three tensors, or the short chunk at the end of
// a row, goes element by element. Out and lse tensors are strided in t and h
// (d contiguous), so a flash output in (B, H, N, D) merges in place of its
// token-major view without a copy.
#include "common.cuh"
#include "dtype.cuh"

namespace {

using namespace lc;  // dtype codes and conversions (dtype.cuh)

constexpr int kThreads = 256;

__device__ __forceinline__ float finite_or_neg(float l) {
  return isfinite(l) ? l : kNegInf;
}

// One thread per (t, h, chunk of VEC = 16 / sizeof(T) elements of d).
// Element (t, h, d) of po, so and o lies at t * st + h * sh + d; lse (t, h)
// of pl, sl and ol at t * lt + h * lh.
template <class T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const T* __restrict__ po, const float* __restrict__ pl,
             const T* __restrict__ so, const float* __restrict__ sl,
             T* __restrict__ o, float* __restrict__ ol, int H, int D,
             long long rows, int chunks, long long st, long long sh,
             long long lt, long long lh) {
  constexpr int VEC = 16 / sizeof(T);
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * chunks) return;
  const int ch = static_cast<int>(idx % chunks);
  const long long th = idx / chunks;
  const long long t = th / H;
  const int h = static_cast<int>(th % H);
  const long long li = t * lt + h * lh;
  const float lp = finite_or_neg(pl[li]), ls = finite_or_neg(sl[li]);
  const float m = fmaxf(lp, ls);
  const float wp = expf(lp - m), ws = expf(ls - m);
  const float den = wp + ws;
  const float fp = wp / den, fs = ws / den;
  if (ch == 0) ol[li] = m + logf(den);

  const int d0 = ch * VEC;
  const long long base = t * st + h * sh + d0;
  const T* a = po + base;
  const T* b = so + base;
  T* y = o + base;
  const bool aligned = d0 + VEC <= D &&
                       ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(y)) % 16) == 0;
  if (aligned) {
    const uint4 ua = *reinterpret_cast<const uint4*>(a);
    const uint4 ub = *reinterpret_cast<const uint4*>(b);
    const T* ea = reinterpret_cast<const T*>(&ua);
    const T* eb = reinterpret_cast<const T*>(&ub);
    uint4 uy;
    T* ey = reinterpret_cast<T*>(&uy);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      ey[i] = from_f32<T>(to_f32(ea[i]) * fp + to_f32(eb[i]) * fs);
    *reinterpret_cast<uint4*>(y) = uy;
  } else {
    const int n = min(VEC, D - d0);
    for (int i = 0; i < n; ++i)
      y[i] = from_f32<T>(to_f32(a[i]) * fp + to_f32(b[i]) * fs);
  }
}

template <class T>
int launch(const void* po, const float* pl, const void* so, const float* sl,
           void* o, float* ol, long long rows, int H, int D, long long st,
           long long sh, long long lt, long long lh, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = (D + VEC - 1) / VEC;
  const long long n = rows * chunks;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  merge_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(po), pl, static_cast<const T*>(so), sl,
      static_cast<T*>(o), ol, H, D, rows, chunks, st, sh, lt, lh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). po, so, o:
// (T, H, D) of dtype ``dtype`` (0 f32, 1 f16, 2 bf16) with strides (st, sh,
// 1) in elements, all three alike; pl, sl, ol: (T, H) f32 with strides (lt,
// lh), all three alike. Launches on ``stream``; does not synchronise and
// allocates nothing.
extern "C" int lc_merge_attn_states(const void* po, const void* pl,
                                    const void* so, const void* sl, void* o,
                                    void* ol, int T, int H, int D, int dtype,
                                    long long st, long long sh, long long lt,
                                    long long lh, void* stream) {
  if (T <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(T) * H;
  const float* plf = static_cast<const float*>(pl);
  const float* slf = static_cast<const float*>(sl);
  float* olf = static_cast<float*>(ol);
  if (dtype == kF32)
    return launch<float>(po, plf, so, slf, o, olf, rows, H, D, st, sh, lt, lh,
                         s);
  if (dtype == kF16)
    return launch<__half>(po, plf, so, slf, o, olf, rows, H, D, st, sh, lt,
                          lh, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(po, plf, so, slf, o, olf, rows, H, D, st, sh,
                                 lt, lh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
