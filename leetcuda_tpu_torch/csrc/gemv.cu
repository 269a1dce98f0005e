// Batch-1 matrix-vector products for Hopper, two entry points in one kernel:
//   gemv:          y (1, N) = x (K) @ W (K, N)
//   rms_norm_gemv: y (1, N) = (x * rsqrt(mean(x^2) + eps) * norm_w) @ W
// x, W (and norm_w) of one dtype (f32, f16 or bf16); products and sums in
// f32, one rounding to the output dtype (f32 when the caller applies an
// epilogue to the sum).
//
// Replaces: leetcuda_tpu/gemm/gemv.py make_gemv (_gemv_kernel) and
// make_rms_norm_gemv (_rms_gemv_kernel). As there, the fused variant
// recomputes the norm's scale from the whole of x in every CTA, so the
// normalised activation never goes to device memory.
//
// Bound on an H100 SXM: bytes. Every element of W is read once (2048 x
// 11264 bf16: 46 MB, 13.8 us at 3.35 TB/s); x and y are small. Design: a CTA
// of 256 threads owns a panel of columns and a range of K. Its threads are
// K_LANES rows by 256 / K_LANES column chunks; each loads 16 bytes of a W
// row a step (consecutive threads on consecutive addresses) and keeps the
// 16 / sizeof(T) column sums in registers; a shared-memory reduction over
// the K lanes ends it. A decode row gives few panels (N = 2048 is 32 panels
// of 64 bf16 columns at K_LANES 32), so the wrapper splits K over enough
// CTAs to give the 132 SMs two each, and a second pass sums the splits'
// f32 partials in a fixed order (deterministic, no atomics).
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };
constexpr int kThreads = 256;

template <class T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_out(void* o, int i, float v, int odt) {
  if (odt == kF32)
    static_cast<float*>(o)[i] = v;
  else if (odt == kF16)
    static_cast<__half*>(o)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(o)[i] = __float2bfloat16_rn(v);
}

// grid (panels, splits). With one split the CTA writes y in ``odt``; with
// more, its f32 partial sums go to part[split][N] for gemv_finish.
template <class T, int KL, bool kRms>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const T* __restrict__ nw, float* __restrict__ part, void* o,
            int K, int N, int kchunk, float eps, int odt) {
  constexpr int VEC = 16 / sizeof(T), CC = kThreads / KL, PANEL = CC * VEC;
  __shared__ float red[KL][PANEL + 1];
  __shared__ float warp_part[kThreads / 32];
  const int tid = threadIdx.x, cc = tid % CC, kl = tid / CC;
  const int n = blockIdx.x * PANEL + cc * VEC;

  float inv = 1.f;
  if constexpr (kRms) {  // rsqrt(mean(x^2) + eps) over all of x
    float ss = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      const float v = to_f32(x[k]);
      ss = fmaf(v, v, ss);
    }
    ss = lc::warp_sum(ss);
    if ((tid & 31) == 0) warp_part[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += warp_part[i];
    inv = rsqrtf(tot / static_cast<float>(K) + eps);
  }

  float acc[VEC] = {};
  const int split = static_cast<int>(blockIdx.y);
  const int k_end = min(K, (split + 1) * kchunk);
  if (n < N) {  // N % VEC == 0: the chunk is all in or all out
    for (int k = split * kchunk + kl; k < k_end; k += KL) {
      float xv = to_f32(x[k]);
      if constexpr (kRms) xv = xv * inv * to_f32(nw[k]);
      const uint4 u = *reinterpret_cast<const uint4*>(w + (size_t)k * N + n);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv, to_f32(e[v]), acc[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < VEC; ++v) red[kl][cc * VEC + v] = acc[v];
  __syncthreads();
  for (int c = tid; c < PANEL; c += kThreads) {
    const int col = blockIdx.x * PANEL + c;
    if (col >= N) continue;
    float s = 0.f;
#pragma unroll 8
    for (int r = 0; r < KL; ++r) s += red[r][c];
    if (gridDim.y == 1)
      store_out(o, col, s, odt);
    else
      part[(size_t)split * N + col] = s;
  }
}

__global__ void gemv_finish(const float* __restrict__ part, void* o, int N,
                            int splits, int odt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += part[(size_t)i * N + n];
  store_out(o, n, s, odt);
}

template <class T, int KL>
int launch(const void* x, const void* w, const void* nw, float* part, void* o,
           int K, int N, int splits, int kchunk, float eps, int odt,
           cudaStream_t st) {
  constexpr int PANEL = (kThreads / KL) * (16 / sizeof(T));
  const dim3 grid((N + PANEL - 1) / PANEL, splits);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (nw)
    gemv_kernel<T, KL, true><<<grid, kThreads, 0, st>>>(
        xt, wt, static_cast<const T*>(nw), part, o, K, N, kchunk, eps, odt);
  else
    gemv_kernel<T, KL, false><<<grid, kThreads, 0, st>>>(
        xt, wt, nullptr, part, o, K, N, kchunk, eps, odt);
  if (splits > 1)
    gemv_finish<<<(N + 255) / 256, 256, 0, st>>>(part, o, N, splits, odt);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_kl(int k_lanes, const void* x, const void* w, const void* nw,
              float* part, void* o, int K, int N, int splits, int kchunk,
              float eps, int odt, cudaStream_t st) {
  switch (k_lanes) {
    case 16:
      return launch<T, 16>(x, w, nw, part, o, K, N, splits, kchunk, eps, odt,
                           st);
    case 32:
      return launch<T, 32>(x, w, nw, part, o, K, N, splits, kchunk, eps, odt,
                           st);
    case 128:
      return launch<T, 128>(x, w, nw, part, o, K, N, splits, kchunk, eps, odt,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch(es) (0 = launched). ``nw``
// null: gemv; else rms_norm_gemv with norm weights nw (K,) and ``eps``.
// ``dtype`` is x's, W's and nw's (0 f32, 1 f16, 2 bf16), ``odt`` the
// output's; ``k_lanes`` 16, 32 or 128 threads along K; ``splits`` CTAs
// along K, each over ``kchunk`` rows (splits > 1 needs ``part``, splits x N
// f32). Needs N % (16 / element size) == 0 and 16-byte aligned operands.
// Launches on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_gemv(const void* x, const void* w, const void* nw,
                       void* part, void* o, int K, int N, int dtype, int odt,
                       int k_lanes, int splits, int kchunk, float eps,
                       void* stream) {
  const int vec = dtype == kF32 ? 4 : 8;
  if (K <= 0 || N <= 0 || N % vec || odt < 0 || odt > 2 || splits < 1 ||
      splits > 65535 || kchunk <= 0 || (long long)splits * kchunk < K ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == kF32)
    return launch_kl<float>(k_lanes, x, w, nw, p, o, K, N, splits, kchunk, eps,
                            odt, st);
  if (dtype == kF16)
    return launch_kl<__half>(k_lanes, x, w, nw, p, o, K, N, splits, kchunk,
                             eps, odt, st);
  if (dtype == kBF16)
    return launch_kl<__nv_bfloat16>(k_lanes, x, w, nw, p, o, K, N, splits,
                                    kchunk, eps, odt, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
