// The fused decode entry block for Hopper: rms-norm -> projection -> RoPE
// in one kernel, and the same kernel without the RoPE (norm -> matmul).
// x (B, D) bf16, norm weight (D,) bf16, w (D, X) bf16, positions (B,) int32
// -> out (B, X) bf16.
//
// Replaces: leetcuda_tpu/gemm/fused_decode.py make_fused_norm_qkv_rope and
// make_fused_norm_matmul (one body, _fused_kernel, with rope_end = 0 for the
// second). Roundings, in the TPU kernel's order: xhat = x_f32 * rsqrt(mean
// (x^2) + eps) rounded to bf16; times the norm weight in bf16 (with
// ``offset``: (1 + w_f32) rounded to bf16 first); the product accumulates
// in f32 and is rounded to bf16 BEFORE the RoPE; the half-rotation RoPE
// runs in f32 on columns < rope_end, with the angle pos_f32 * powf(theta,
// -i / half) (i the column's index inside its half of the head) through the
// accurate powf / sincosf (positions reach thousands, where the fast
// intrinsics are useless); one more rounding to bf16.
//
// Bound on an H100 SXM: bytes. The weight streams once: D=2048, X=3072 is
// 12.6 MB, 3.8 us at 3.35 TB/s (X=11264: 46.1 MB, 13.8 us); at B <= 16 rows
// the arithmetic (2 B D X FLOP) is negligible.
//
// Design: a cluster split-K over the whole card, one launch.
// * A panel is two boxes of kBox (32) columns, c0 + [0, kBox) and c1 + [0,
//   kBox). For the RoPE they are columns i and i + Dh/2 of one head (c1 =
//   c0 + Dh/2), so every RoPE partner lies in its column's panel at head
//   dim 64, 128 or 256 and a panel is 64 columns at any head dim; the norm
//   -> matmul form takes c1 = c0 + kBox (64 contiguous columns).
// * A cluster of C CTAs (1-8) owns a panel; rank r the rows [r kc, min(D,
//   (r + 1) kc)). gemm/fused_decode.py fused_plan picks C: the most ranks
//   whose grid fits one wave of the card (cudaOccupancyMaxActiveClusters).
//   Rows of x past 8 go to further row tiles (grid.y), which read the
//   panel again.
// * Each rank streams its slice of w through a ring of kStages (2) stages
//   of kRows (128) rows, 16 KB a stage (hopper.cuh Ring: thread 0 fills the
//   first, the warp whose release completes a stage issues its next load):
//   2-D TMA boxes with the 64-byte swizzle on mbarriers, no register round
//   trip and no block-wide barrier a stage. With ~80 registers a thread and
//   ~60 KB of shared memory a CTA, 3 CTAs an SM: ~96 KB in flight an SM.
//   bench/gemm_bench.py --fused (an NVIDIA H100 80GB HBM3, 700 W; device
//   alone) chose the ring: more stages in flight ran slower (16 stages of
//   32 rows: 0.0164 ms at ModelConfig against 8's 0.0147), and 2 of 128
//   rows led or came within 2% of every other ring at the three shapes.
// * While the first stages fly, warp w sums the squares of row w of x over
//   all of D (a lane's 16-byte words in order by fmaf, 8 loads in flight,
//   the warp's xor tree: every rank the same rstd, bit for bit; summing
//   only the slice and exchanging the ranks' parts lost the A/B) and
//   writes the normalised bf16 values of its rank's slice only into shared
//   memory (zeros past the slice and past B), 4 words of x and of the norm
//   weight in flight a lane.
// * The product is the swapped out^T = W^T x^T on mma.sync m16n8k16: the
//   panel's columns are M (4 tiles of 16), the row tile's 8 rows are N (no
//   lane wasted at B = 8), and the A fragments come from the swizzled stage
//   by ldmatrix.trans. Warp w takes m tile w % 4 and the k16 steps of
//   parity w / 4 of every stage.
// * The sums: the two k parities of a CTA in order through shared memory,
//   a thread holding both columns of its RoPE pairs; every rank but 0
//   stores its (8 x 64) f32 partials into rank 0's shared memory and
//   arrives on rank 0's mbarrier (release at cluster scope, as csrc/gemv.cu
//   does); rank 0 computes its pairs' angles while they arrive, adds the
//   ranks in rank order, rounds to bf16, applies the RoPE below rope_end
//   and writes 16-byte words. No partial buffer, no second launch, no
//   atomics: two calls agree bit for bit.
// * The launch (cudaLaunchKernelEx with a cluster dimension) allocates
//   nothing, reads positions on the device and never synchronises, so a
//   CUDA graph captures it.
// The bench's variant builds set LC_FUSED_BOX (64: panels of 128 columns,
// the 128-byte swizzle; head dim 128 or 256), LC_FUSED_ROWS and
// LC_FUSED_STAGES, and its probes LC_FUSED_PROBE (wrong results: 1 no pass
// over x, 2 no products, 3 no exchange between the ranks, 4 no feed: no
// TMA and no waits).
#include "common.cuh"
#include "hopper.cuh"

#ifndef LC_FUSED_BOX
#define LC_FUSED_BOX 32  // columns of a box; a panel is two boxes
#endif
#ifndef LC_FUSED_ROWS
#define LC_FUSED_ROWS 128  // k rows of a stage
#endif
#ifndef LC_FUSED_STAGES
#define LC_FUSED_STAGES 2  // stages of the ring
#endif
#ifndef LC_FUSED_PROBE
#define LC_FUSED_PROBE 0  // bench probes (wrong results), see above
#endif

namespace {

using namespace lc;
using namespace lc::sm90;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kRowTile = 8;  // rows of x a CTA: the mma's N
constexpr int kXLoads = 8;   // 16-byte words of x a lane has in flight
constexpr int kBox = LC_FUSED_BOX;
constexpr int kPanel = 2 * kBox;  // columns of a panel
constexpr int kRows = LC_FUSED_ROWS;
constexpr int kStages = LC_FUSED_STAGES;
// x's rows a rank stages in shared memory at most: the plan's kc
constexpr int kMaxRows = 8192;
// the dynamic limit set once a device: with the static arrays (~20 KB at
// boxes of 32 columns, ~35 KB at 64) within the 227 KB a block can have
constexpr int kMaxSmem = (kBox == 32 ? 200 : 190) * 1024;
constexpr int kRowBytes = kBox * 2;  // a box row: 64 (or 128) bytes
constexpr int kBoxBytes = kRows * kRowBytes;
constexpr int kStageBytes = 2 * kBoxBytes;
constexpr int kMTiles = kPanel / 16;     // m16 tiles of a panel
constexpr int kKGroups = kWarps / kMTiles;  // warps along k
constexpr int kLdr = kPanel + 4;  // floats a row of the partial tiles
static_assert(kBox == 32 || kBox == 64, "a box row of 64 or 128 bytes");
static_assert(kRows % (16 * kKGroups) == 0, "whole k16 steps a k group");
static_assert(kBoxBytes % 1024 == 0, "boxes on the swizzle's period");
static_assert(kWarps == kRowTile, "a warp normalises a row of x");

struct WMap {
  CUtensorMap map;  // w (D, X) in boxes of kRows x kBox, swizzled
};

__device__ __forceinline__ void unpack8(uint4 v, float f[8]) {
  const uint32_t ws[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(ws[e] << 16);
    f[2 * e + 1] = __uint_as_float(ws[e] & 0xffff0000u);
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return bf16_to_f32(f32_to_bf16(x));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The byte offset of row k, 16-byte chunk ch of a box as TMA's swizzle
// (64- or 128-byte) lays it: the chunk XOR-ed with the offset's bits 7+.
__device__ __forceinline__ uint32_t swz(int k, int ch) {
  const int off = k * kRowBytes;
  return off + 16 * (ch ^ ((off >> 7) & (kRowBytes / 16 - 1)));
}

// The dynamic shared memory of a CTA over kc rows: 1 KB of alignment slack,
// the ring (no more stages than the slice has) and x's slice (kRowTile
// rows of kc + 8 bf16).
__host__ __device__ inline int fused_smem(int kc) {
  const int nst = (kc + kRows - 1) / kRows;
  return 1024 + (nst < kStages ? nst : kStages) * kStageBytes +
         kRowTile * (kc + 8) * 2;
}

// grid (panels C, row tiles) in clusters of C along x: cluster p owns the
// panel of boxes at columns c0 = h Dh + q kBox and c1 = c0 + half (h = p /
// hp, q = p % hp, hp = half / kBox panels a head; the matmul form passes
// Dh = kPanel, half = kBox), its rank r the rows [r kc, min(D, (r + 1)
// kc)); the row tile m0 = 8 blockIdx.y.
template <bool kRope>
__global__ void __launch_bounds__(kThreads, 2)
fused_norm_matmul_kernel(const uint16_t* __restrict__ x,
                         const uint16_t* __restrict__ nw,
                         const int* __restrict__ pos,
                         uint16_t* __restrict__ o, int B, int D, int X,
                         int kc, float eps, int offset, int rope_end, int Dh,
                         float theta, const __grid_constant__ WMap wm) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages];
  __shared__ int released[kStages];
  __shared__ uint64_t gathered;  // rank 0: the ranks' arrivals
  __shared__ float red[kKGroups][kRowTile][kLdr];
  __shared__ float2 gather[kMaxCluster - 1][kRowTile * kBox];
  __shared__ __align__(16) uint16_t ob[kRowTile][kPanel];
  uint8_t* stages = align1024(smem_raw);
  const int C = static_cast<int>(cluster_nctarank());
  const int rank = C > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int nst_max = (kc + kRows - 1) / kRows;
  uint16_t* xs = reinterpret_cast<uint16_t*>(
      stages + (nst_max < kStages ? nst_max : kStages) * kStageBytes);
  const int ldx = kc + 8;  // (kc + 8) / 2 = 4 mod 32 words: b reads spread
  const Ring<kStages, kWarps> ring{full, released};

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p = static_cast<int>(blockIdx.x) / C;
  const int m0 = static_cast<int>(blockIdx.y) * kRowTile;
  const int half = Dh / 2, hp = half / kBox;
  const int q = p % hp;
  const int c0 = (p / hp) * Dh + q * kBox, c1 = c0 + half;
  const int k0 = min(D, rank * kc), k1 = min(D, k0 + kc);
  const int nst = (k1 - k0 + kRows - 1) / kRows;

  if (tid == 0) {
    ring.init();
    if (C > 1 && rank == 0) mbar_init(&gathered, C - 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (C > 1) cluster_arrive();  // waited on before the first remote arrival
  auto issue = [&](int i, int s, uint64_t* bar) {
    uint8_t* st = stages + s * kStageBytes;
    mbar_expect_tx(bar, kStageBytes);
    tma_load_2d(st, &wm.map, bar, c0, k0 + i * kRows);
    tma_load_2d(st + kBoxBytes, &wm.map, bar, c1, k0 + i * kRows);
  };
  if (tid == 0 && LC_FUSED_PROBE != 4) {
    prefetch_map(&wm.map);
    ring.start(nst, issue);
  }

  // row m0 + warp of x: its sum of squares over all of D, then its rank's
  // slice normalised into xs[warp] (zeros past k1 and past B)
  {
    const int row = m0 + warp;
    uint16_t* dst = xs + warp * ldx;
    const int n8 = kc / 8, live8 = (k1 - k0) / 8;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * D);
    // a lane's words w = lane, lane + 32, ... of [w0, w1) summed in order,
    // loaded kXLoads at a time, then the warp's xor tree
    auto sumsq = [&](int w0, int w1) {
      float ss = 0.f;
      for (int cb = w0 + lane; cb < w1; cb += 32 * kXLoads) {
        uint4 v[kXLoads];
#pragma unroll
        for (int u = 0; u < kXLoads; ++u)
          if (cb + 32 * u < w1) v[u] = xr[cb + 32 * u];
#pragma unroll
        for (int u = 0; u < kXLoads; ++u) {
          if (cb + 32 * u >= w1) break;
          float f[8];
          unpack8(v[u], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss = fmaf(f[e], f[e], ss);
        }
      }
      return warp_sum(ss);
    };
    if (row < B && LC_FUSED_PROBE != 1) {
      const float ss = sumsq(0, D / 8);
      const float rstd = rsqrtf(ss / static_cast<float>(D) + eps);
      // the slice's words of x (from L1 after the sum) and of the norm
      // weight, kXLoads / 2 of each in flight a lane, normalised to bf16;
      // zeros past k1
      const uint4* xk = xr + k0 / 8;
      const uint4* wk = reinterpret_cast<const uint4*>(nw) + k0 / 8;
      constexpr int kSl = kXLoads / 2;
      for (int cb = lane; cb < n8; cb += 32 * kSl) {
        uint4 xv[kSl], gv[kSl];
#pragma unroll
        for (int u = 0; u < kSl; ++u)
          if (cb + 32 * u < live8) {
            xv[u] = xk[cb + 32 * u];
            gv[u] = wk[cb + 32 * u];
          }
#pragma unroll
        for (int u = 0; u < kSl; ++u) {
          const int c = cb + 32 * u;
          if (c >= n8) break;
          uint4 out = make_uint4(0u, 0u, 0u, 0u);
          if (c < live8) {
            float f[8], g[8];
            unpack8(xv[u], f);
            unpack8(gv[u], g);
            uint32_t v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float y[2];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float xhat = round_bf16(f[2 * e + h] * rstd);
                const float wn =
                    offset ? round_bf16(1.f + g[2 * e + h]) : g[2 * e + h];
                y[h] = xhat * wn;
              }
              v[e] = pack_bf16x2(y[0], y[1]);
            }
            out = make_uint4(v[0], v[1], v[2], v[3]);
          }
          *reinterpret_cast<uint4*>(dst + c * 8) = out;
        }
      }
    } else {
      for (int c = lane; c < n8; c += 32)
        *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();  // xs written

  // the product: warp (mt, kg) = (warp % kMTiles, warp / kMTiles) takes
  // columns [16 mt, 16 mt + 16) of the panel and the k16 steps j = kg,
  // kg + kKGroups, ... of each stage
  const int mt = warp % kMTiles, kg = warp / kMTiles;
  const int g = lane >> 2, t = lane & 3;
  const int box = (16 * mt) / kBox, cb = (16 * mt) % kBox;
  // this lane's ldmatrix row: matrix lane / 8 (m half lane / 8 & 1, k half
  // lane / 16), row lane % 8
  const int lk = (lane >> 4) * 8 + (lane & 7);
  const int lch = cb / 8 + ((lane >> 3) & 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint16_t* xb = xs + g * ldx + 2 * t;
  for (int i = 0; i < nst; ++i) {
    if (LC_FUSED_PROBE != 4) ring.wait(i);
    const uint32_t st = smem_u32(stages + (i % kStages) * kStageBytes) +
                        box * kBoxBytes;
#pragma unroll
    for (int j = kg; j < kRows / 16; j += kKGroups) {
      uint32_t a[4], b[2];
      ldsm_x4_trans(a, st + swz(16 * j + lk, lch));
      const int kk = i * kRows + 16 * j;
      b[0] = lds32(xb + kk);
      b[1] = lds32(xb + kk + 8);
      if (LC_FUSED_PROBE != 2) mma_bf16_16816(acc, a, b);
    }
    if (LC_FUSED_PROBE != 4) ring.release(i, nst, lane, issue);
  }

  // this thread's RoPE pairs pr = tid + u kThreads: row pr / kBox of the
  // tile, columns c0 + i and c1 + i (i = pr % kBox), frequency index q kBox
  // + i inside the head's half
  constexpr int kPairs = kRowTile * kBox / kThreads;  // pairs a thread
  const bool roped = kRope && c0 < rope_end;
  float rc[kPairs], rs[kPairs];
  auto angles = [&] {
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      const int pr = tid + u * kThreads, r = pr / kBox, i = pr % kBox;
      rc[u] = 1.f;
      rs[u] = 0.f;
      if (roped && m0 + r < B) {
        const float inv_freq =
            powf(theta, -static_cast<float>(q * kBox + i) /
                            static_cast<float>(half));
        sincosf(static_cast<float>(pos[m0 + r]) * inv_freq, &rs[u], &rc[u]);
      }
    }
  };

  // acc: columns 16 mt + g (+ 8 in acc[2], acc[3]), rows 2 t, 2 t + 1
  red[kg][2 * t][16 * mt + g] = acc[0];
  red[kg][2 * t + 1][16 * mt + g] = acc[1];
  red[kg][2 * t][16 * mt + g + 8] = acc[2];
  red[kg][2 * t + 1][16 * mt + g + 8] = acc[3];
  __syncthreads();
  // the k groups' sums of this thread's pairs in order; then every rank but
  // 0 stores its sums into rank 0's shared memory and arrives on rank 0's
  // barrier (release at cluster scope), and rank 0 adds the ranks' sums in
  // rank order
  float2 sp[kPairs];
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    const int pr = tid + u * kThreads, r = pr / kBox, i = pr % kBox;
    sp[u] = make_float2(red[0][r][i], red[0][r][kBox + i]);
#pragma unroll
    for (int k = 1; k < kKGroups; ++k) {
      sp[u].x += red[k][r][i];
      sp[u].y += red[k][r][kBox + i];
    }
  }
  if (C > 1) cluster_wait();  // rank 0's barrier initialised
  if (C > 1 && LC_FUSED_PROBE != 3) {
    if (rank != 0) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u)
        st_cluster_f32x2(&gather[rank - 1][tid + u * kThreads], 0, sp[u]);
      fence_cluster();
      __syncthreads();
      if (tid == 0) mbar_arrive_release_cluster(&gathered, 0);
      return;
    }
    angles();  // while the peers' sums arrive
    mbar_wait_acquire_cluster(&gathered, 0);
#pragma unroll
    for (int u = 0; u < kPairs; ++u)
      for (int r = 1; r < C; ++r) {
        const float2 v = gather[r - 1][tid + u * kThreads];
        sp[u].x += v.x;
        sp[u].y += v.y;
      }
  }
  if (C == 1 || LC_FUSED_PROBE == 3) angles();
  // rounded to bf16, then the RoPE on the pair (f32), rounded again
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    const int pr = tid + u * kThreads, r = pr / kBox, i = pr % kBox;
    float x1 = round_bf16(sp[u].x), x2 = round_bf16(sp[u].y);
    if (roped) {
      const float y1 = x1 * rc[u] - x2 * rs[u];
      const float y2 = x2 * rc[u] + x1 * rs[u];
      x1 = y1;
      x2 = y2;
    }
    ob[r][i] = f32_to_bf16(x1);
    ob[r][kBox + i] = f32_to_bf16(x2);
  }
  __syncthreads();
  constexpr int kChunks = kPanel / 8;  // 16-byte words a row
  for (int e = tid; e < kRowTile * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e % kChunks;
    const int col = ch < kChunks / 2 ? c0 + 8 * ch : c1 + 8 * (ch - kChunks / 2);
    if (m0 + r < B && col < X)
      *reinterpret_cast<uint4*>(o + (size_t)(m0 + r) * X + col) =
          *reinterpret_cast<const uint4*>(&ob[r][8 * ch]);
  }
}

// w (D, X) bf16, row-major, in boxes of kRows x kBox with the box rows'
// swizzle; boxes past D or X read zeros.
int encode_w(CUtensorMap* map, const void* w, int D, int X) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(X),
                              static_cast<cuuint64_t>(D)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(X) * 2};
  const cuuint32_t boxd[2] = {static_cast<cuuint32_t>(kBox),
                              static_cast<cuuint32_t>(kRows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, boxd, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kBox == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// One launch, or with ``clusters`` the occupancy query and no launch.
template <bool kRope>
int launch(const void* x, const void* nw, const void* w, const void* pos,
           void* o, int B, int D, int X, float eps, int offset, int rope_end,
           int Dh, float theta, int cluster, int kc, void* stream,
           int* clusters) {
  if (B <= 0 || D <= 0 || X <= 0 || D % 8 || X % 8 || Dh % (2 * kBox) ||
      cluster < 1 || cluster > kMaxCluster || kc <= 0 || kc % kRows ||
      kc > kMaxRows || static_cast<long long>(cluster) * kc < D ||
      (cluster > 1 && (cluster - 1) * kc >= D) || (B + kRowTile - 1) /
      kRowTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = fused_norm_matmul_kernel<kRope>;
  static unsigned long long attr_devices = 0;
  const int smem = fused_smem(kc);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = smem_limit_per_device(kern, kMaxSmem, attr_devices);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const int panels = (X + kPanel - 1) / kPanel;
  cfg.gridDim = dim3(panels * cluster, (B + kRowTile - 1) / kRowTile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) {
    cfg.gridDim = dim3(cluster * 132);
    return static_cast<int>(
        cudaOccupancyMaxActiveClusters(clusters, kern, &cfg));
  }
  WMap wm;
  const int err = encode_w(&wm.map, w, D, X);
  if (err) return err;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const uint16_t*>(x),
                         static_cast<const uint16_t*>(nw),
                         static_cast<const int*>(pos),
                         static_cast<uint16_t*>(o), B, D, X, kc, eps, offset,
                         rope_end, Dh, theta, wm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points return a CUDA error code (0 = launched). They launch on
// ``stream``, do not synchronise and allocate nothing. They take
// ``cluster`` CTAs (1-8) a panel, each over ``kc`` rows (a multiple of
// LC_FUSED_ROWS, at most 8192; no rank empty: (cluster - 1) kc < D <=
// cluster kc), D % 8 == 0, X % 8 == 0 and 16-byte aligned operands
// (gemm/fused_decode.py fused_plan picks cluster and kc).
//
// out (B, X) = rope(rms_norm(x) @ wqkv) with X = (H + 2 Hkv) Dh, RoPE on the
// first (H + Hkv) Dh columns; head_dim 64, 128 or 256.
extern "C" int lc_fused_norm_qkv_rope(const void* x, const void* norm_w,
                                      const void* wqkv, const void* positions,
                                      void* out, int B, int D, int n_heads,
                                      int n_kv_heads, int head_dim, float eps,
                                      float theta, int rms_offset,
                                      int cluster, int kc, void* stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const int X = (n_heads + 2 * n_kv_heads) * head_dim;
  const int rope_end = (n_heads + n_kv_heads) * head_dim;
  return launch<true>(x, norm_w, wqkv, positions, out, B, D, X, eps,
                      rms_offset, rope_end, head_dim, theta, cluster, kc,
                      stream, nullptr);
}

// out (B, X) = rms_norm(x) @ w.
extern "C" int lc_fused_norm_matmul(const void* x, const void* norm_w,
                                    const void* w, void* out, int B, int D,
                                    int X, float eps, int rms_offset,
                                    int cluster, int kc, void* stream) {
  return launch<false>(x, norm_w, w, nullptr, out, B, D, X, eps, rms_offset,
                       0, kPanel, 0.f, cluster, kc, stream, nullptr);
}

// The clusters of ``cluster`` CTAs over ``kc`` rows that the current device
// holds at once (cudaOccupancyMaxActiveClusters) for the RoPE form
// (``rope`` 1) or the matmul form, into *out.
extern "C" int lc_fused_clusters(int rope, int cluster, int kc, int* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int D = cluster * kc;  // a D that ``cluster`` ranks of kc take
  if (rope)
    return launch<true>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, D,
                        kPanel, 1e-5f, 0, 0, kPanel, 1.f, cluster, kc,
                        nullptr, out);
  return launch<false>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, D,
                       kPanel, 1e-5f, 0, 0, kPanel, 1.f, cluster, kc, nullptr,
                       out);
}

// The build's constants, for the wrapper's plan: out[0..4] = columns of a
// box, k rows of a stage, stages, rows a rank at most, CTAs a cluster at
// most.
extern "C" int lc_fused_info(int* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = kBox;
  out[1] = kRows;
  out[2] = kStages;
  out[3] = kMaxRows;
  out[4] = kMaxCluster;
  return 0;
}
