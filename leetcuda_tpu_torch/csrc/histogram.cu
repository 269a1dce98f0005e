// Histogram for Hopper: int32 counts of the int32 values of a flat
// contiguous (S, K) over ``bins`` bins; values outside [0, bins) are
// dropped, as the Pallas kernel's one-hot compare drops them.
//
// Replaces: leetcuda_tpu/ops/histogram.py make_histogram
// (_histogram_kernel_2d).
//
// Bound on an H100 SXM: bytes, each value read once and each bin written
// once (a (16384, 2048) int32 input: 134 MB, 40 us at 3.35 TB/s), as long
// as the atomics keep up. The TPU has no atomics and sums a one-hot cube
// into a revisited output block; Hopper has them, as the reference's
// atomicAdd(&hist[a[i]], 1) uses. Design, simple first: the launch sequence
// zeroes the output itself (cudaMemsetAsync), then each CTA keeps a private
// histogram in shared memory where bins * 4 bytes fit (dynamic shared
// memory, opted in above 48 KB, so that 32000 bins, 125 KB, fit), counts its
// grid-stride share into it with shared-memory atomics, and adds each
// non-zero bin to the output with one device atomic. Where the bins do not
// fit, the same walk adds straight into the output in device memory. A
// thread takes VEC values a step (the i32 rung 1, i32x4 4 in one 16-byte
// load where aligned); a value outside [0, bins) is skipped before any
// atomic (the reference's unguarded atomicAdd would write out of bounds).
// Integer atomics commute, so the counts are exact and the same on every
// run.
#include "vec_io.cuh"

namespace {

using namespace lc;

constexpr int kThreads = 256;
constexpr int kMaxCtas = 528;        // 4 CTAs of 256 threads per SM
constexpr int kStepsPerThread = 16;  // CTAs: one per 16 vectors a thread

// One value into histogram h: values outside [0, bins) are dropped.
__device__ __forceinline__ void count(int* h, int v, int bins) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(bins))
    atomicAdd(&h[v], 1);
}

template <int VEC, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ x, long long n, long long head,
                long long nvec, int bins, int* out) {
  extern __shared__ int smem[];
  int* h = SHARED ? smem : out;
  if constexpr (SHARED) {
    for (int b = threadIdx.x; b < bins; b += blockDim.x) smem[b] = 0;
    __syncthreads();
  }
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < nvec; i += stride) {
    int v[VEC];
    load_raw<int, VEC, 4 * VEC>(x + head + i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) count(h, v[j], bins);
  }
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x, tail = head + nvec * VEC;
    if (t < head) count(h, x[t], bins);
    if (tail + t < n) count(h, x[tail + t], bins);
  }
  if constexpr (SHARED) {
    __syncthreads();
    for (int b = threadIdx.x; b < bins; b += blockDim.x)
      if (smem[b]) atomicAdd(&out[b], smem[b]);
  }
}

template <int VEC>
cudaError_t run(const int* x, long long n, int bins, int* out,
                cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int) * bins, stream);
  if (err != cudaSuccess || n == 0) return err;
  const Split s = split_flat(x, n, sizeof(int), VEC, 4 * VEC);
  long long ctas = (s.nvec + kThreads * kStepsPerThread - 1) /
                   (kThreads * kStepsPerThread);
  ctas = ctas < 1 ? 1 : (ctas > kMaxCtas ? kMaxCtas : ctas);
  int dev = 0, optin = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  const size_t smem = sizeof(int) * static_cast<size_t>(bins);
  if (smem <= static_cast<size_t>(optin)) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             hist_kernel<VEC, true>,
             cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    hist_kernel<VEC, true><<<static_cast<int>(ctas), kThreads, smem, stream>>>(
        x, n, s.head, s.nvec, bins, out);
  } else {
    hist_kernel<VEC, false><<<static_cast<int>(ctas), kThreads, 0, stream>>>(
        x, n, s.head, s.nvec, bins, out);
  }
  return cudaGetLastError();
}

}  // namespace

// out[b] = the number of the n values of contiguous int32 x equal to b, for
// b in [0, bins); ``vec`` 1 or 4 values a thread a step.
extern "C" int lc_histogram(const int* x, long long n, int bins, int* out,
                            int vec, void* stream) {
  if (n < 0 || bins <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (vec == 1)
    err = run<1>(x, n, bins, out, s);
  else if (vec == 4)
    err = run<4>(x, n, bins, out, s);
  return static_cast<int>(err);
}
