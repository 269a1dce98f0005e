// Ring collectives over the ranks of a mesh axis: the right permute and the
// double-buffered ring all-gather, for ranks whose buffers share one GPU.
//
// Replaces: leetcuda_tpu/parallel/ring_pallas.py ppermute_pallas
// (_right_permute_kernel) and ring_all_gather_pallas
// (_ring_all_gather_kernel): device-initiated remote copies between TPU
// chips, each rank's transfer signalled on a DMA semaphore.
//
// Both kernels move bytes, never values, so any dtype goes through bit for
// bit (NaN payloads, e4m3's 0x7F / 0xFF). A rank's buffers are given as a
// table of n input and n output pointers, passed by value with the launch
// (``Ptrs``, up to kMaxRanks ranks): the kernel reads it from the parameter
// bank and no table is uploaded per call.
//
// Bound on an H100 SXM: bytes. The permute reads each rank's chunk of C
// bytes once and writes it once (2 n C); the all-gather must at least read
// the n chunks and write n copies of the n-chunk result (n C + n^2 C). With
// ranks on one card every hop is a copy through device memory, so the ring
// moves more than that bound: the seed (3 C a rank: the chunk read, then
// written to the output and the comm slot), then each of the n - 1 steps
// reads and writes the comm slot and copies it out (4 C a rank a step):
// 31 C a rank at n = 8 against the bound's 9 C. On an H100 at 8 ranks of
// 64 MiB it moves them at 2.5 TB/s (6.66 ms against 1.44).
//
// Design.
// - lc_ppermute: grid (K, n), a CTA (c, r) copies slice c of rank r's chunk
//   into rank (r + 1) % n's output. No CTA waits for another.
// - lc_ring_all_gather: JAX's schedule, not a concatenation. Rank r first
//   deposits its chunk in out[r][r] and in its comm slot 0; at step s (0 ..
//   n - 2) it writes its slot s % 2 into the right rank's slot (s + 1) % 2,
//   waits until its own slot (s + 1) % 2 has been filled by the left rank,
//   and copies it to out[r][(r - s - 1) mod n] (JAX's src_dev). The TPU's
//   DMA semaphores become flags in device memory, one pair per (rank, CTA),
//   so that CTA c of rank r pairs only with CTA c of its neighbours (the
//   slicing is the same on every rank):
//   * arrived: the left rank's CTA sets it to s + 1 after its step-s stores,
//     a __threadfence() and a barrier, with st.release.gpu;
//   * consumed: the CTA sets it to s + 1 once its step-s forward has read
//     its slot s % 2, the credit without which a left rank one step ahead
//     would overwrite a slot not yet forwarded (slot (s + 1) % 2 of the
//     right rank is written at step s only after consumed >= s there).
//   Waits spin on ld.acquire.gpu (thread 0, then a barrier). The flags count
//   steps from 0, so the wrapper zeroes them before each launch.
// - The spins need every CTA resident at once: the launch is cooperative
//   (cudaLaunchCooperativeKernel), K n CTAs at most the occupancy times the
//   SM count, else cudaErrorCooperativeLaunchTooLarge.
// - Every spin is bounded: past ``budget`` polls (the wrapper's default
//   2^22, ~2-4 s), or once another CTA has set the error word, a CTA sets
//   the error word and returns. The wrapper reads it and raises, so a
//   protocol fault fails in seconds, not hangs (a budget of 0 fails the
//   first wait that is not already met: the check that the path works).
// - Copies move 16-byte words where the source and destination share their
//   alignment modulo 16 (after a byte head), bytes otherwise; four words a
//   thread in flight. Loads bypass L1 (ld.global.cg): a comm slot is written
//   by another SM during the kernel.
// Ranks on distinct devices (peer access, .sys-scope flags, one launch per
// device) wait for a machine with two or more GPUs (ROADMAP item 12).
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;
constexpr long long kMinSlice = 64 * 1024;   // bytes a CTA at least
constexpr int kMaxPermuteCtas = 1024;        // a few CTAs an SM

struct Ptrs {
  const unsigned char* in[kMaxRanks];
  unsigned char* out[kMaxRanks];
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.global.acquire.gpu.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.global.release.gpu.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// dst[0, n) = src[0, n) by the CTA's threads.
__device__ void copy_bytes(unsigned char* dst, const unsigned char* src,
                           long long n) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  long long head = n;
  if (((d ^ s) & 15) == 0) {
    head = static_cast<long long>((16 - (d & 15)) & 15);
    if (head > n) head = n;
  }
  for (long long i = tid; i < head; i += nth) dst[i] = __ldcg(src + i);
  const long long words = (n - head) / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (long long i = tid; i < words; i += 4LL * nth) {
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + static_cast<long long>(u) * nth;
      if (j < words) v[u] = __ldcg(s4 + j);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = i + static_cast<long long>(u) * nth;
      if (j < words) d4[j] = v[u];
    }
  }
  for (long long i = head + words * 16 + tid; i < n; i += nth)
    dst[i] = __ldcg(src + i);
}

// Thread 0 polls ``flag`` until it reaches ``target``; false (and the error
// word set) past ``budget`` polls or once another CTA has given up.
__device__ bool wait_at_least(const int* flag, int target, int* err,
                              long long budget) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    int good = 1;
    long long polls = 0;
    while (ld_acquire(flag) < target) {
      if (++polls > budget ||
          *reinterpret_cast<volatile int*>(err) != 0) {
        atomicExch(err, 1);
        good = 0;
        break;
      }
      __nanosleep(128);
    }
    ok = good;
  }
  __syncthreads();
  const bool good = ok != 0;
  __syncthreads();  // every thread has read ok before it is written again
  return good;
}

__global__ void __launch_bounds__(kThreads)
ppermute_kernel(Ptrs p, long long bytes, long long slice, int n) {
  const int c = blockIdx.x, r = blockIdx.y;
  const long long b0 = c * slice;
  const long long len = bytes - b0 < slice ? bytes - b0 : slice;
  if (len <= 0) return;
  copy_bytes(p.out[(r + 1) % n] + b0, p.in[r] + b0, len);
}

// comm: (n, 2, pitch) bytes, slot (r, k) at (2 r + k) pitch; flags: (n, K,
// 2) ints, [arrived, consumed] of CTA c of rank r at 2 (r K + c).
__global__ void __launch_bounds__(kThreads)
ring_all_gather_kernel(Ptrs p, unsigned char* comm, int* flags, int* err,
                       long long chunk, long long pitch, long long slice,
                       long long budget, int n) {
  const int c = blockIdx.x, r = blockIdx.y, K = gridDim.x;
  const long long b0 = c * slice;
  const long long len = chunk - b0 < slice ? chunk - b0 : slice;
  if (len <= 0) return;  // so is every rank's CTA c: the slicing is shared
  const int right = (r + 1) % n;
  unsigned char* mine = comm + 2LL * r * pitch + b0;
  unsigned char* theirs = comm + 2LL * right * pitch + b0;
  int* arrived = flags + 2 * (r * K + c);  // set by the left rank
  int* consumed = arrived + 1;             // set here, read by the left rank
  int* arrived_right = flags + 2 * (right * K + c);
  const int* consumed_right = arrived_right + 1;
  unsigned char* out = p.out[r];

  copy_bytes(out + static_cast<long long>(r) * chunk + b0, p.in[r] + b0, len);
  copy_bytes(mine, p.in[r] + b0, len);
  __syncthreads();  // the seed is in slot 0 before it is forwarded
  for (int s = 0; s < n - 1; ++s) {
    const int send = s & 1, recv = send ^ 1;
    // the right rank has forwarded (step s - 1) what its slot recv held
    if (s > 0 && !wait_at_least(consumed_right, s, err, budget)) return;
    copy_bytes(theirs + recv * pitch, mine + send * pitch, len);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      st_release(arrived_right, s + 1);
      st_release(consumed, s + 1);
    }
    if (!wait_at_least(arrived, s + 1, err, budget)) return;
    const int src = (r - s - 1 + n) % n;
    copy_bytes(out + static_cast<long long>(src) * chunk + b0,
               mine + recv * pitch, len);
  }
}

// CTAs a rank: one per kMinSlice bytes, at least 1, at most ``cap``.
int ctas_per_rank(long long bytes, long long cap) {
  long long k = (bytes + kMinSlice - 1) / kMinSlice;
  if (k > cap) k = cap;
  return static_cast<int>(k < 1 ? 1 : k);
}

long long slice_of(long long bytes, int k) {
  const long long s = (bytes + k - 1) / k;
  return (s + 15) / 16 * 16;
}

int fill(Ptrs& p, const void* const* in, void* const* out, int n) {
  if (n < 1 || n > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < n; ++r) {
    p.in[r] = static_cast<const unsigned char*>(in[r]);
    p.out[r] = static_cast<unsigned char*>(out[r]);
  }
  return 0;
}

}  // namespace

// Both return a CUDA error code (0 = launched), launch on ``stream``, do
// not synchronise and allocate nothing. ``in`` and ``out`` are host arrays
// of n device pointers.
//
// out[(r + 1) % n][0, bytes) = in[r][0, bytes) for every rank r.
extern "C" int lc_ppermute(const void* const* in, void* const* out, int n,
                           long long bytes, void* stream) {
  Ptrs p;
  if (int e = fill(p, in, out, n)) return e;
  if (bytes <= 0) return 0;
  const int k = ctas_per_rank(bytes, kMaxPermuteCtas / n);
  if (k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  ppermute_kernel<<<dim3(k, n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, bytes, slice_of(bytes, k), n);
  return static_cast<int>(cudaGetLastError());
}

// out[r][s chunk, (s + 1) chunk) = in[s][0, chunk) for every r and s, by the
// ring. comm: n * 2 * pitch bytes of scratch (pitch >= chunk, a multiple of
// 16); flags: zero, two ints for each CTA the device can hold resident
// (at most maxThreadsPerMultiProcessor / kThreads on each SM); err: one
// int, zero, non-zero after a wait ran out of its ``budget`` of polls.
// ``ctas``: CTAs a rank, 0 for one per kMinSlice bytes of the chunk, at
// most what keeps all n ranks' CTAs resident at once. More than that is
// refused (cudaErrorCooperativeLaunchTooLarge), as is n ranks of which
// not even one CTA each fits.
extern "C" int lc_ring_all_gather(const void* const* in, void* const* out,
                                  void* comm, void* flags, void* err, int n,
                                  long long chunk, long long pitch, int ctas,
                                  long long budget, void* stream) {
  Ptrs p;
  if (int e = fill(p, in, out, n)) return e;
  if (chunk <= 0) return 0;
  if (ctas < 0 || pitch < chunk || pitch % 16 || budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ring_all_gather_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const long long resident = static_cast<long long>(per_sm) * sms;
  if (ctas == 0 && resident >= n)
    ctas = ctas_per_rank(chunk, resident / n);
  if (ctas == 0 || static_cast<long long>(ctas) * n > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  unsigned char* c = static_cast<unsigned char*>(comm);
  int* f = static_cast<int*>(flags);
  int* w = static_cast<int*>(err);
  long long slice = slice_of(chunk, ctas);
  void* args[] = {&p, &c, &f, &w, &chunk, &pitch, &slice, &budget, &n};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ring_all_gather_kernel), dim3(ctas, n),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
