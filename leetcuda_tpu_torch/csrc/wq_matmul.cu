// Weight-only quantized matmul, w8a16, for Hopper: out (M, N) bf16 =
// (x (M, K) bf16 @ W (K, N)) * s (N,), W int8 or e4m3, s f32.
//
// Replaces: leetcuda_tpu/gemm/quant.py make_matmul_w8a16 (_wq_mm_kernel):
// the quantized weight block is cast up right after its load, the product
// accumulates in f32, and the per-output-channel scale is applied once to
// the f32 accumulator before the one rounding to bf16. The conversion is
// exact: |q| <= 127 is a bf16 integer, and every e4m3 value is a bf16
// value; e4m3 decodes through the hardware cvt to f16 (bytes 0x7F and 0xFF
// are NaN, as the TPU's bit decode makes them, core/runtime.py
// e4m3_bits_to_f32).
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): bytes at decode, where
// M = 8 and the weight stream dominates (K=2048, N=11264: 23.1 MB, 6.9 us);
// operations at the ragged admission of 8 x 1536 rows (M=12288, K=2048,
// N=11264: 567 GFLOP, 0.573 ms).
//
// Two routes by row count (gemm/quant.py w8_plan picks them):
// - Decode rows (a few): w4_matmul.cu's design on bytes. The swapped product
//   out^T = W^T x^T on wgmma: a CTA is two warpgroups and owns 128 output
//   columns (64 a warpgroup, the wgmma's M) by BM rows (the wgmma's N: 8,
//   16, 32 or 64). TMA feeds a ring of stages (hopper.cuh Ring): 64 weight
//   rows x 128 columns of bytes and the x tile (BM x 64 bf16, K-major, the
//   B operand). Each thread converts its A fragments (W^T, n x k) straight
//   from the byte tile, two 16-bit loads a fragment pair (rows k, k + 1 of
//   its two adjacent columns; the fragment's rows permuted over the columns
//   as in w4_matmul.cu), and issues RS wgmma, converting the next step's
//   fragments while one runs. K is split over the card (grid.z) toward two
//   CTAs an SM; each split writes its f32 partial to a workspace and the
//   last CTA of an output tile to finish (a counter the wrapper keeps
//   zeroed and the CTA zeroes again) sums the partials in split order,
//   applies the scale and writes the tile: one launch, no float atomics,
//   the same bits on every call.
// - Prefill rows: two launches, two entry points. lc_w8_to_bf16 converts
//   the weight exactly into a bf16 scratch (K, N) (23 MB read, 46 MB
//   written for w_gate_up: ~0.02 ms at the memory rate); then the dense
//   matmul's persistent kernel (gemm_sm90.cuh, its 128 x 256 tile: a
//   producer thread feeding a ring of TMA stages, two consumer warpgroups on
//   wgmma m64n256 with x as the SS A operand, CTA pairs multicasting the
//   weight panel) applies the scale to the f32 sums in its TMA-store
//   epilogue and rounds once. The A/B of bench/gemm_bench.py --w8 chose it
//   over converting inside the kernel (TMA bringing the weight tile as
//   bytes and the producer warpgroup's two spare warps converting it into
//   the bf16 B stage: those two warps could not keep up with the tensor
//   cores, 2.6-3.3x the two-pass time at M = 12288; PERF.md row 10).
#include <cuda_fp8.h>

#include "common.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

#ifndef LC_W8_STAGES
#define LC_W8_STAGES 4  // stages of the decode route's ring
#endif
#ifndef LC_W8_PROBE
#define LC_W8_PROBE 0  // bench probe, wrong results: 1 decode without wgmma
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

constexpr int kStageRows = 64;  // weight rows (k) of a stage
constexpr int kSteps = kStageRows / 16;
constexpr int kBN = 128;  // output columns of a decode CTA
constexpr int kThreads = 256;
constexpr int kStages = LC_W8_STAGES;
static_assert(kStages >= 2, "a stage is released one step after its last");

template <int BM>
struct W8Tile {
  static constexpr int W_BYTES = kStageRows * kBN;  // 8 KB
  static constexpr int X_BYTES = BM * 128;          // BM x 64 bf16
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  // from a 1024-byte aligned base: the stages, then kStages mbarriers,
  // kStages release counters and the last-CTA flag
  static constexpr int SMEM_BYTES =
      1024 + kStages * STAGE_BYTES + 16 * kStages + 16;
  static_assert(BM % 8 == 0 && BM <= 64, "decode rows");
  static_assert(SMEM_BYTES <= 232448, "w8a16 stages exceed the shared memory");
};

struct Maps {
  CUtensorMap x, w;
};

// The two e4m3 bytes in the low half of ``w`` (the low byte first) as a
// bf16x2, exactly: the hardware cvt to f16 (every e4m3 value is an f16
// value; bytes 0x7F and 0xFF give NaN, as core/runtime.py's decode makes
// them), then f32, then bf16 (at most 4 significant bits: no rounding).
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t w) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return bf16x2_bits(f.x, f.y);
}

// 16 weight bytes (columns c .. c + 15 of one k-row) as 16 bf16 values,
// exactly: lo holds columns c .. c + 7, hi c + 8 .. c + 15, the smaller
// column in the low half of each word.
template <bool kFp8>
__device__ __forceinline__ void bytes_to_bf16(const uint4 v, uint4& lo,
                                              uint4& hi) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[8];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if constexpr (!kFp8) {
      // 0x4B0000uu is 2^23 + uu as f32; with uu = byte ^ 0x80 = q + 128,
      // minus 2^23 + 128 it is q, which bf16 holds exactly
      const uint32_t u = in[w] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) -
               8388736.f;
      out[2 * w] = bf16x2_bits(f[0], f[1]);
      out[2 * w + 1] = bf16x2_bits(f[2], f[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 2; ++p)
        out[2 * w + p] = e4m3x2_to_bf16x2(in[w] >> (16 * p));
    }
  }
  lo = make_uint4(out[0], out[1], out[2], out[3]);
  hi = make_uint4(out[4], out[5], out[6], out[7]);
}

// Four weight bytes of one fragment pair word, u = (r, n0) (r, n0 + 1)
// (r + 1, n0) (r + 1, n0 + 1), as the bf16x2 (rows r, r + 1) of column
// n0 + h.
template <bool kFp8>
__device__ __forceinline__ uint32_t pair_bf16x2(uint32_t u, int h) {
  if constexpr (kFp8) {
    return e4m3x2_to_bf16x2(__byte_perm(u, 0u, h ? 0x4431 : 0x4420));
  } else {
    const uint32_t v = u ^ 0x80808080u;  // q + 128
    const float lo =
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 + h)) - 8388736.f;
    const float hi =
        __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7542 + h)) - 8388736.f;
    return bf16x2_bits(lo, hi);
  }
}

// The A fragments of k16 step ``kk`` of the byte tile ``wt`` for this thread
// (warp ``w`` of warpgroup ``c``, g, t): a[2 j + h] holds k rows 16 kk + 8 j
// + 2 t, + 1 of column 64 c + 16 w + 2 g + h.
template <bool kFp8>
__device__ __forceinline__ void convert_step(const uint8_t* wt, int kk, int c,
                                             int w, int g, int t,
                                             uint32_t (&a)[4]) {
  const int chunk = 4 * c + w;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = 16 * kk + 8 * j + 2 * t;
    const uint32_t w0 = *reinterpret_cast<const uint16_t*>(
        wt + r * 128 + ((chunk ^ (r & 7)) << 4) + 2 * g);
    const uint32_t w1 = *reinterpret_cast<const uint16_t*>(
        wt + (r + 1) * 128 + ((chunk ^ ((r + 1) & 7)) << 4) + 2 * g);
    const uint32_t u = w0 | (w1 << 16);
#pragma unroll
    for (int h = 0; h < 2; ++h) a[2 * j + h] = pair_bf16x2<kFp8>(u, h);
  }
}

template <int BM, bool kFp8>
__global__ void __launch_bounds__(kThreads, 1)
w8_decode_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ scale, uint16_t* __restrict__ o,
                 float* __restrict__ ws, int* __restrict__ counters, int M,
                 int N, int K) {
  using T = W8Tile<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + kStages * T::STAGE_BYTES);
  int* released = reinterpret_cast<int*>(full + kStages);
  int* last_flag = released + kStages;
  const Ring<kStages, 8> ring{full, released};

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, sp = blockIdx.z;
  const int nk = ceil_div(K, kStageRows), sps = ceil_div(nk, splits);
  const int s_lo = sp * sps, n_stages = min(nk, s_lo + sps) - s_lo;
  const int c = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  if (threadIdx.x == 0) {
    ring.init();
    fence_mbar_init();
  }
  __syncthreads();
  auto issue = [&](int i, int s, uint64_t* bar) {
    mbar_expect_tx(bar, T::STAGE_BYTES);
    uint8_t* st = stages + s * T::STAGE_BYTES;
    const int k0 = (s_lo + i) * kStageRows;
    tma_load_2d(st, &maps.w, bar, n0, k0);
    tma_load_2d(st + T::W_BYTES, &maps.x, bar, k0, m0);
  };
  if (threadIdx.x == 0) {
    prefetch_map(&maps.x);
    prefetch_map(&maps.w);
    ring.start(n_stages, issue);
  }

  // this thread's columns n, n + 1 (fragment rows g, g + 8)
  const int n = n0 + 64 * c + 16 * warp + 2 * g;
  float acc[BM / 2];
  zero(acc);
  uint32_t fr[2][4];  // [step parity][register]
  ring.wait(0);
  convert_step<kFp8>(stages, 0, c, warp, g, t, fr[0]);
  for (int i = 0; i < n_stages; ++i) {
    uint8_t* st = stages + (i % kStages) * T::STAGE_BYTES;
    const uint32_t xs = smem_u32(st + T::W_BYTES);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      fence_acc(acc);
      wgmma_fence();
      if (LC_W8_PROBE != 1)
        wgmma_rs_bf16<0>(acc, fr[kk & 1], kmajor(xs + kk * 32),
                         i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step: its fragments are free
      fence_acc(acc);
      fence_frag(fr);
      // stage i - 1 is read once step 0 of stage i waited on its last step
      if (kk == 0 && i > 0) ring.release(i - 1, n_stages, lane, issue);
      // the next step's fragments while this step runs
      if (kk + 1 < kSteps) {
        convert_step<kFp8>(st, kk + 1, c, warp, g, t, fr[(kk + 1) & 1]);
      } else if (i + 1 < n_stages) {
        ring.wait(i + 1);
        convert_step<kFp8>(stages + ((i + 1) % kStages) * T::STAGE_BYTES, 0,
                           c, warp, g, t, fr[0]);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  const float2 sc = n < N ? *reinterpret_cast<const float2*>(scale + n)
                          : make_float2(0.f, 0.f);
  store_split_k<BM>(acc, sc, o, ws,
                    counters + blockIdx.y * gridDim.x + blockIdx.x, last_flag,
                    M, N, m0, n, t, sp, splits);
}

template <int BM>
int launch_decode(const void* x, const void* w, const void* s, void* o,
                  void* ws, void* counters, int M, int N, int K, bool fp8,
                  int splits, cudaStream_t stream) {
  using T = W8Tile<BM>;
  auto kern =
      fp8 ? &w8_decode_kernel<BM, true> : &w8_decode_kernel<BM, false>;
  static unsigned long long devices[2] = {0, 0};
  if (cudaError_t e = smem_limit_per_device(kern, T::SMEM_BYTES, devices[fp8]))
    return static_cast<int>(e);
  Maps maps;
  if (int e = map_2d(&maps.x, x, false, M, K, K, BM, 64)) return e;
  if (int e = map_2d_u8(&maps.w, w, K, N, N, kStageRows, kBN)) return e;
  const dim3 grid(ceil_div(N, kBN), ceil_div(M, BM), splits);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<grid, kThreads, T::SMEM_BYTES, stream>>>(
      maps, static_cast<const float*>(s), static_cast<uint16_t*>(o),
      static_cast<float*>(ws), static_cast<int*>(counters), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ prefill rows

// The dense kernel's 128 x 256 tile, on the bf16 copy of the weight.
using Prefill = GemmPlan<128, 256, 3, 2, 1, kBkn>;

// The first pass of the prefill route: w (K, N) bytes -> wb (K, N) bf16,
// exactly, 16 bytes a thread (K * N a multiple of 16).
template <bool kFp8>
__global__ void __launch_bounds__(256)
w8_to_bf16(const uint4* __restrict__ w, uint4* __restrict__ wb,
           size_t chunks) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < chunks;
       i += (size_t)gridDim.x * blockDim.x) {
    uint4 lo, hi;
    bytes_to_bf16<kFp8>(__ldg(w + i), lo, hi);
    wb[2 * i] = lo;
    wb[2 * i + 1] = hi;
  }
}

}  // namespace

// The prefill route's first pass: ``n`` weight bytes w (int8, or e4m3 with
// ``fp8``) -> wb, n bf16 values, exactly (e4m3 bytes 0x7F and 0xFF give
// NaN). Needs n % 16 == 0 and 16-byte aligned operands. Returns
// cudaGetLastError() after the launch (0 = launched); launches on
// ``stream`` and does not synchronise.
extern "C" int lc_w8_to_bf16(const void* w, void* wb, long long n, int fp8,
                             void* stream) {
  if (n <= 0 || n % 16) return static_cast<int>(cudaErrorInvalidValue);
  const size_t chunks = static_cast<size_t>(n) / 16;
  const size_t blocks = (chunks + 255) / 256;
  const int grid = static_cast<int>(blocks < 1056 ? blocks : 1056);
  auto kern = fp8 ? &w8_to_bf16<true> : &w8_to_bf16<false>;
  kern<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(w), static_cast<uint4*>(wb), chunks);
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) bf16. ``route`` 0: decode rows, w the weight bytes (int8, or
// e4m3 with ``fp8``), BM rows a CTA (8, 16, 32 or 64) and K cut into
// ``splits`` splits of whole 64-row stages (cdiv(K / 64, splits) each, none
// empty); splits > 1 needs ``ws`` (splits, M, N) f32 and ``counters``
// (cdiv(M, BM) * cdiv(N, 128) ints, zero at launch, zero again after it).
// ``route`` 1: prefill rows, w the weight converted to bf16 (K, N) by
// lc_w8_to_bf16, ``grid`` CTAs of the persistent kernel (a multiple of 2,
// at most the co-resident count: lc_wq_matmul_info), its tiles walked
// ``group`` tile-columns at a time (0: row-major). Needs M > 0, K % 8 == 0,
// N % 16 == 0 and 16-byte aligned operands. Returns cudaGetLastError()
// after the launch (0 = launched); launches on ``stream``, does not
// synchronise and allocates nothing.
extern "C" int lc_wq_matmul_bf16(const void* x, const void* w, const void* s,
                                 void* o, void* ws, void* counters, int M,
                                 int N, int K, int fp8, int route, int bm,
                                 int splits, int group, int grid,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return gemm_sm90_launch<Prefill, false, true>(
        x, w, static_cast<const float*>(s), o, M, N, K, kBF16, group, grid,
        st);
  const int nk = ceil_div(K, kStageRows);
  if (route != 0 || splits < 1 || splits > nk ||
      ceil_div(nk, ceil_div(nk, splits)) != splits ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bm) {
    case 8:
      return launch_decode<8>(x, w, s, o, ws, counters, M, N, K, fp8, splits,
                              st);
    case 16:
      return launch_decode<16>(x, w, s, o, ws, counters, M, N, K, fp8,
                               splits, st);
    case 32:
      return launch_decode<32>(x, w, s, o, ws, counters, M, N, K, fp8,
                               splits, st);
    case 64:
      return launch_decode<64>(x, w, s, o, ws, counters, M, N, K, fp8,
                               splits, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// (LC_W8_PROBE 1, for bench/gemm_bench.py --w8, computes nothing right: the
// decode route without its products, and ptxas then drops the conversion
// whose results go nowhere: the feed alone.)
// What this build runs, for the current device: info = {decode stages,
// then the prefill kernel's BM, BN, BK, stages, cluster and co-resident
// CTAs}. Returns a CUDA error code.
extern "C" int lc_wq_matmul_info(int* info) {
  info[0] = kStages;
  return gemm_sm90_info<Prefill, false, true>(info + 1);
}
