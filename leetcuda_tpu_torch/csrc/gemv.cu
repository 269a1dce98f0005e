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
// 11264 bf16: 46 MB, 13.8 us at 3.35 TB/s); x and y are small. Design: one
// launch a call. A CTA of 256 threads is KL rows (threads along K, the
// ladder's k_lanes) by 256 / KL column chunks of 16 bytes; a cluster of C
// CTAs shares one panel of (256 / KL) (16 / size) columns, CTA rank r
// taking rows [r kc, min(K, (r + 1) kc)). gemm/gemv.py gemv_plan picks C:
// 1 where the panels alone give every SM a CTA, else the most that one wave
// of the card holds (cudaOccupancyMaxActiveClusters), so the grid never
// spills into a ragged second wave. Each thread streams its rows' 16-byte
// words of W in two batches of kUnroll (4) independent loads, the second in
// flight while the first is summed and each reissued two batches ahead once
// summed (4-8 loads in flight a thread), both issued before the CTA stages
// x: x goes to shared memory once a CTA, as f32, normalised there in the
// fused form (its sum of squares over all of x in a fixed order). The CTA
// sums its KL lanes in order through shared memory; then every rank but 0
// stores its panel sums into rank 0's shared memory (distributed shared
// memory) and arrives on rank 0's mbarrier, and rank 0 adds them in rank
// order and writes, inside the launch: no partial buffer, no second
// launch, and two calls agree bit for bit. LC_GEMV_TMA = 1 builds the
// bench's other feed: a ring of LC_GEMV_STAGES shared-memory stages of
// LC_GEMV_ROWS rows of the panel, filled by 2-D TMA boxes that thread 0
// issues on mbarriers.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"
#include "dtype.cuh"
#include "hopper.cuh"

#ifndef LC_GEMV_UNROLL
#define LC_GEMV_UNROLL 4  // loads a thread has in flight in each batch
#endif
#ifndef LC_GEMV_TMA
#define LC_GEMV_TMA 0  // 1: the bench's TMA-ring variant
#endif
#ifndef LC_GEMV_ROWS
#define LC_GEMV_ROWS 64  // the TMA variant's rows a stage
#endif
#ifndef LC_GEMV_STAGES
#define LC_GEMV_STAGES 4  // the TMA variant's stages
#endif

namespace {

using namespace lc;  // dtype codes and conversions (dtype.cuh)

constexpr int kThreads = 256;
constexpr int kUnroll = LC_GEMV_UNROLL;
constexpr int kMaxCluster = 8;
// x's rows in shared memory at most (f32): the plan's kc stays below it
constexpr int kMaxRows = 40960;
constexpr int kMaxSmem = 200 * 1024;  // the dynamic limit set once a device
constexpr int kRingRows = LC_GEMV_ROWS, kStages = LC_GEMV_STAGES;

template <class T>
__device__ __forceinline__ float elem(const uint4& u, int e) {
  return to_f32(reinterpret_cast<const T*>(&u)[e]);
}

struct RingMap {
  CUtensorMap map;  // W (K, N) in boxes of kRingRows x panel (TMA variant)
};

// grid (panels C,) in clusters of C = %cluster_nctarank along x: cluster p
// owns columns [p P, (p + 1) P), P = CC VEC, and its rank r the rows [k0,
// k1) = [r kc, min(K, (r + 1) kc)). Thread t = kl CC + cc sums the 16-byte
// word of columns p P + cc VEC + [0, VEC) over rows k0 + kl, k0 + kl + KL,
// ... in order (f32 fma, x's value as staged). Dynamic shared memory: kc
// floats of x (then, in the TMA variant, the ring). Writes y in ``odt``.
template <class T, int KL, bool kRms>
__global__ void __launch_bounds__(kThreads, 2)
gemv_cluster(const T* __restrict__ x, const T* __restrict__ w,
             const T* __restrict__ nw, void* __restrict__ o, int K, int N,
             int kc, float eps, int odt, const __grid_constant__ RingMap rm) {
  constexpr int VEC = 16 / sizeof(T), CC = kThreads / KL, P = CC * VEC;
  extern __shared__ float4 dyn[];
  float* xs = reinterpret_cast<float*>(dyn);
  __shared__ float red[KL][P];
  __shared__ float gather[kMaxCluster][P];  // rank 0: every rank's sums
  __shared__ uint64_t gathered;             // rank 0: the ranks' arrivals
  __shared__ float warp_part[kThreads / 32];
  const int C = static_cast<int>(sm90::cluster_nctarank());
  const int rank = C > 1 ? static_cast<int>(sm90::cluster_ctarank()) : 0;
  const int tid = threadIdx.x, cc = tid % CC, kl = tid / CC;
  const int p0 = static_cast<int>(blockIdx.x) / C * P;
  const int n = p0 + cc * VEC;
  const int k0 = min(K, rank * kc), k1 = min(K, k0 + kc);
  float acc[VEC] = {};
  if (C > 1) {  // rank 0's barrier, ready before any peer arrives on it
    if (rank == 0 && tid == 0) {
      sm90::mbar_init(&gathered, C - 1);
      sm90::fence_mbar_init();
    }
    sm90::cluster_arrive();  // waited on before the first remote arrival
  }

#if LC_GEMV_TMA
  // the ring: kStages stages of kRingRows x P elements after x's kc
  // floats, from the next 128-byte boundary (a TMA destination's)
  T* ring = reinterpret_cast<T*>(
      (reinterpret_cast<uintptr_t>(xs + kc) + 127) & ~uintptr_t{127});
  __shared__ uint64_t full[kStages];
  const int nst = (k1 - k0 + kRingRows - 1) / kRingRows;
  constexpr uint32_t kStageBytes = kRingRows * P * sizeof(T);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::fence_mbar_init();
    sm90::prefetch_map(&rm.map);
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < min(kStages, nst); ++i) {
      sm90::mbar_expect_tx(&full[i], kStageBytes);
      sm90::tma_load_2d(ring + i * kRingRows * P, &rm.map, &full[i], p0,
                        k0 + i * kRingRows);
    }
  }
#else
  // this thread's rows k0 + kl + j KL, j < nr; W's word of row k at wp + j
  // KL N; two batches, a and b, issued before x is staged
  const int nr = n < N && k1 > k0 + kl ? (k1 - k0 - kl + KL - 1) / KL : 0;
  const T* wp = w + static_cast<size_t>(k0 + kl) * N + n;
  const size_t step = static_cast<size_t>(KL) * N;
  auto issue = [&](uint4 (&buf)[kUnroll], int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (j0 + u < nr)
        buf[u] = __ldcs(reinterpret_cast<const uint4*>(wp + (j0 + u) * step));
  };
  uint4 a[kUnroll] = {}, b[kUnroll] = {};
  issue(a, 0);
  issue(b, kUnroll);
#endif

  // x's rows [k0, k1) to shared memory as f32; in the fused form times
  // rsqrt(mean(x^2) + eps) (the sum of squares over all of x: thread tid's
  // elements tid, tid + 256, ... in order, each warp's xor tree, the warps
  // in order) and norm_w
  float inv = 1.f;
  if constexpr (kRms) {
    float ss = 0.f;
    for (int k = tid; k < K; k += kThreads) {
      const float v = to_f32(x[k]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if ((tid & 31) == 0) warp_part[tid >> 5] = ss;
    __syncthreads();
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) tot += warp_part[i];
    inv = rsqrtf(tot / static_cast<float>(K) + eps);
  }
  for (int k = k0 + tid; k < k1; k += kThreads) {
    float v = to_f32(x[k]);
    if constexpr (kRms) v = v * inv * to_f32(nw[k]);
    xs[k - k0] = v;
  }
  __syncthreads();

#if LC_GEMV_TMA
  for (int i = 0; i < nst; ++i) {
    const int s = i % kStages;
    sm90::mbar_wait(&full[s], (i / kStages) & 1);
    const T* st = ring + s * kRingRows * P;
#pragma unroll 4
    for (int r = kl; r < kRingRows; r += KL) {
      const int k = k0 + i * kRingRows + r;
      if (k < k1 && n < N) {
        const float xv = xs[k - k0];
        const uint4 u = *reinterpret_cast<const uint4*>(st + r * P + cc * VEC);
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = fmaf(xv, elem<T>(u, v), acc[v]);
      }
    }
    __syncthreads();  // stage s read by every thread
    if (tid == 0 && i + kStages < nst) {
      sm90::fence_proxy_async_shared();
      sm90::mbar_expect_tx(&full[s], kStageBytes);
      sm90::tma_load_2d(ring + s * kRingRows * P, &rm.map, &full[s], p0,
                        k0 + (i + kStages) * kRingRows);
    }
  }
#else
  // sum a batch's rows in order, then reuse its registers for the batch
  // two ahead: one batch in flight while the other is summed
  auto consume = [&](const uint4 (&buf)[kUnroll], int j0) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < nr) {
        const float xv = xs[kl + (j0 + u) * KL];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          acc[v] = fmaf(xv, elem<T>(buf[u], v), acc[v]);
      }
    }
  };
  for (int j0 = 0; j0 < nr; j0 += 2 * kUnroll) {
    consume(a, j0);
    issue(a, j0 + 2 * kUnroll);
    consume(b, j0 + kUnroll);
    issue(b, j0 + 3 * kUnroll);
  }
#endif

  // the KL lanes' sums of each column in lane order; then every rank but
  // 0 stores its sums into rank 0's shared memory and arrives on rank 0's
  // barrier (release at cluster scope), and rank 0 adds the ranks' sums in
  // rank order and writes the panel
#pragma unroll
  for (int v = 0; v < VEC; ++v) red[kl][cc * VEC + v] = acc[v];
  __syncthreads();
  float s = 0.f;
  if (tid < P) {
#pragma unroll 8
    for (int r = 0; r < KL; ++r) s += red[r][tid];
  }
  if (C > 1) {
    sm90::cluster_wait();  // rank 0's barrier initialised
    if (rank != 0) {
      if (tid < P) {
        sm90::st_cluster_f32(&gather[rank][tid], 0, s);
        sm90::fence_cluster();
      }
      __syncthreads();
      if (tid == 0) sm90::mbar_arrive_release_cluster(&gathered, 0);
      return;
    }
    sm90::mbar_wait_acquire_cluster(&gathered, 0);
    if (tid < P)
      for (int r = 1; r < C; ++r) s += gather[r][tid];
  }
  if (tid < P && p0 + tid < N) store_any(o, odt, p0 + tid, s);
}

// The dynamic shared memory of a CTA over kc rows: x's kc floats (then the
// TMA variant's ring).
template <class T, int KL>
int gemv_smem(int kc) {
  constexpr int P = (kThreads / KL) * (16 / sizeof(T));
  int bytes = kc * 4;
  if (LC_GEMV_TMA) bytes += 128 + kStages * kRingRows * P * sizeof(T);
  return bytes;
}

template <class T, int KL, bool kRms>
int launch(const void* x, const void* w, const void* nw, void* o, int K,
           int N, int cluster, int kc, float eps, int odt, cudaStream_t st,
           int* clusters) {
  constexpr int P = (kThreads / KL) * (16 / sizeof(T));
  auto kern = gemv_cluster<T, KL, kRms>;
  static unsigned long long attr_devices = 0;
  const int smem = gemv_smem<T, KL>(kc);
  cudaError_t e = smem_limit_per_device(kern, kMaxSmem, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const int panels = (N + P - 1) / P;
  cfg.gridDim = dim3(panels * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) {  // the occupancy query, no launch
    cfg.gridDim = dim3(cluster * 132);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
  }
  RingMap rm = {};
#if LC_GEMV_TMA
  {
    const sm90::EncodeTiledFn fn = sm90::encode_tiled();
    if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * sizeof(T)};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(P),
                               static_cast<cuuint32_t>(kRingRows)};
    const cuuint32_t unit[2] = {1, 1};
    const CUtensorMapDataType dt =
        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const CUresult r =
        fn(&rm.map, dt, 2, const_cast<void*>(w), dims, strides, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
#endif
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                         static_cast<const T*>(w), static_cast<const T*>(nw),
                         o, K, N, kc, eps, odt, rm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool kRms>
int launch_kl(int k_lanes, const void* x, const void* w, const void* nw,
              void* o, int K, int N, int cluster, int kc, float eps, int odt,
              cudaStream_t st, int* clusters) {
  switch (k_lanes) {
    case 16:
      return launch<T, 16, kRms>(x, w, nw, o, K, N, cluster, kc, eps, odt, st,
                                 clusters);
    case 32:
      return launch<T, 32, kRms>(x, w, nw, o, K, N, cluster, kc, eps, odt, st,
                                 clusters);
    case 128:
      return launch<T, 128, kRms>(x, w, nw, o, K, N, cluster, kc, eps, odt,
                                  st, clusters);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class T>
int launch_t(bool rms, int k_lanes, const void* x, const void* w,
             const void* nw, void* o, int K, int N, int cluster, int kc,
             float eps, int odt, cudaStream_t st, int* clusters) {
  if (rms)
    return launch_kl<T, true>(k_lanes, x, w, nw, o, K, N, cluster, kc, eps,
                              odt, st, clusters);
  return launch_kl<T, false>(k_lanes, x, w, nw, o, K, N, cluster, kc, eps,
                             odt, st, clusters);
}

int gemv_call(bool rms, const void* x, const void* w, const void* nw,
              void* o, int K, int N, int dtype, int odt, int k_lanes,
              int cluster, int kc, float eps, cudaStream_t st,
              int* clusters) {
  if (dtype == kF32)
    return launch_t<float>(rms, k_lanes, x, w, nw, o, K, N, cluster, kc, eps,
                           odt, st, clusters);
  if (dtype == kF16)
    return launch_t<__half>(rms, k_lanes, x, w, nw, o, K, N, cluster, kc, eps,
                            odt, st, clusters);
  if (dtype == kBF16)
    return launch_t<__nv_bfloat16>(rms, k_lanes, x, w, nw, o, K, N, cluster,
                                   kc, eps, odt, st, clusters);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns cudaGetLastError() after the one launch (0 = launched). ``nw``
// null: gemv; else rms_norm_gemv with norm weights nw (K,) and ``eps``.
// ``dtype`` is x's, W's and nw's (0 f32, 1 f16, 2 bf16), ``odt`` the
// output's; ``k_lanes`` 16, 32 or 128 threads along K; ``cluster`` CTAs (1-8)
// a column panel, each over ``kc`` rows (cluster x kc >= K, kc <= 40960).
// Needs N % (16 / element size) == 0 and 16-byte aligned operands.
// Launches on ``stream``; does not synchronise and allocates nothing.
extern "C" int lc_gemv(const void* x, const void* w, const void* nw, void* o,
                       int K, int N, int dtype, int odt, int k_lanes,
                       int cluster, int kc, float eps, void* stream) {
  const int vec = dtype == kF32 ? 4 : 8;
  if (K <= 0 || N <= 0 || N % vec || odt < 0 || odt > 2 || cluster < 1 ||
      cluster > kMaxCluster || kc <= 0 || kc > kMaxRows ||
      static_cast<long long>(cluster) * kc < K)
    return static_cast<int>(cudaErrorInvalidValue);
  return gemv_call(nw != nullptr, x, w, nw, o, K, N, dtype, odt, k_lanes,
                   cluster, kc, eps, static_cast<cudaStream_t>(stream),
                   nullptr);
}

// The clusters of ``cluster`` CTAs over ``kc`` rows that the current device
// holds at once (cudaOccupancyMaxActiveClusters) for one instantiation
// (``rms`` 1: the fused form's), into *out.
extern "C" int lc_gemv_clusters(int dtype, int k_lanes, int rms, int cluster,
                                int kc, int* out) {
  if (cluster < 1 || cluster > kMaxCluster || kc <= 0 || kc > kMaxRows ||
      out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return gemv_call(rms != 0, nullptr, nullptr, nullptr, nullptr, kc, 8, dtype,
                   0, k_lanes, cluster, kc, 0.f, nullptr, out);
}
