// Matrix transpose for Hopper: out (K, S) = x (S, K)^T, any S and K, any
// element of 1, 2 or 4 bytes (moved as raw bits, so NaN payloads survive).
//
// Replaces: leetcuda_tpu/ops/transpose.py make_transpose (_transpose_kernel),
// whose rungs are named after the reference's CUDA ladder and differ on the
// TPU only in their block and their tile walk order.
//
// Bound on an H100 SXM: bytes. x is read once and out written once (8192^2
// f32: 537 MB, 0.160 ms at 3.35 TB/s). Design: a CTA of 256 threads owns a
// 64 x 64 tile of x; the grid walks the tiles in the rung's order (the
// Pallas grid's): col2row row-major over x's tiles, row2col column-major,
// diagonal tile (i, (i + j) mod nj), a bijection on any grid. The variant
// is how the tile crosses the SM:
// - kScalar (the f32 rungs): an element a thread at a time, no shared
//   memory; col2row reads x along its rows (writes strided), row2col writes
//   out along its rows (reads strided), as the reference's kernels do;
// - kReg (f32x4, cute_reg): a thread loads a 4 x 4 block as four 4-element
//   vectors (16 bytes in f32), transposes it in registers and stores four
//   vectors;
// - kShared / kSharedBcf / kSwizzled (shared, shared_bcf, cute_smem,
//   cute_smem_swizzled): the tile is staged in shared memory, read from x
//   and written to out along rows in 4-element vectors; the staging tile is
//   plain, padded by one element a row (bank-conflict free), or XOR-
//   swizzled in 4-element groups.
// A 4-element vector is one load or store only where its address is
// aligned to its size and all four elements lie inside the matrix; else it
// is taken an element at a time (a row off a 16-byte boundary when K % 4 !=
// 0, the ragged edge of the last tiles).
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64, kThreads = 256;

enum Variant { kScalar = 0, kReg = 1, kShared = 2, kSharedBcf = 3,
               kSwizzled = 4 };
enum Order { kCol2Row = 0, kRow2Col = 1, kDiagonal = 2 };

// Four elements as one word of 4 * sizeof(T) bytes.
template <class T>
struct Vec4;
template <>
struct Vec4<uint8_t> { using type = uint32_t; };
template <>
struct Vec4<uint16_t> { using type = uint2; };
template <>
struct Vec4<uint32_t> { using type = uint4; };

// Up to four elements at p (``n`` of them lie inside the matrix): one word
// load where p is aligned and n == 4, else one element at a time.
template <class T>
__device__ __forceinline__ void load4(const T* p, int n, T (&v)[4]) {
  using V = typename Vec4<T>::type;
  if (n >= 4 && reinterpret_cast<uintptr_t>(p) % sizeof(V) == 0) {
    const V w = *reinterpret_cast<const V*>(p);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = e[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = i < n ? p[i] : T(0);
  }
}

template <class T>
__device__ __forceinline__ void store4(T* p, int n, const T (&v)[4]) {
  using V = typename Vec4<T>::type;
  if (n >= 4 && reinterpret_cast<uintptr_t>(p) % sizeof(V) == 0) {
    V w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = v[i];
    *reinterpret_cast<V*>(p) = w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) p[i] = v[i];
  }
}

// Linear block b -> x's tile (ti, tj) in the rung's walk order.
template <int ORDER>
__device__ __forceinline__ void tile_of(int b, int ni, int nj, int& ti,
                                        int& tj) {
  if (ORDER == kRow2Col) {
    tj = b / ni;
    ti = b % ni;
  } else {
    ti = b / nj;
    tj = b % nj;
    if (ORDER == kDiagonal) tj = (ti + tj) % nj;
  }
}

// Offset of tile element (r, c) in the staging buffer.
template <int VARIANT>
__device__ __forceinline__ int staged(int r, int c) {
  if (VARIANT == kSharedBcf) return r * (kTile + 1) + c;
  if (VARIANT == kSwizzled) return r * kTile + (c ^ ((r & 15) << 2));
  return r * kTile + c;
}

template <class T, int VARIANT, int ORDER>
__global__ void __launch_bounds__(kThreads)
transpose_kernel(const T* __restrict__ x, T* __restrict__ out, int S, int K) {
  __shared__ T tile[kTile * (kTile + 1)];
  int ti, tj;
  tile_of<ORDER>(blockIdx.x, (S + kTile - 1) / kTile, (K + kTile - 1) / kTile,
                 ti, tj);
  const int r0 = ti * kTile, c0 = tj * kTile, t = threadIdx.x;

  if (VARIANT == kScalar) {
#pragma unroll 4
    for (int e = t; e < kTile * kTile; e += kThreads) {
      // col2row / diagonal: consecutive threads along a row of x;
      // row2col: along a row of out (down a column of x)
      const int lr = ORDER == kRow2Col ? e % kTile : e / kTile;
      const int lc = ORDER == kRow2Col ? e / kTile : e % kTile;
      const int r = r0 + lr, c = c0 + lc;
      if (r < S && c < K) out[(size_t)c * S + r] = x[(size_t)r * K + c];
    }
    return;
  }

  // 4 x 4 blocks: thread (bx, by) of 16 x 16 owns rows 4 by.., columns
  // 4 bx.. of the tile (row2col: consecutive threads down the tile)
  const int bx = ORDER == kRow2Col ? t / 16 : t % 16;
  const int by = ORDER == kRow2Col ? t % 16 : t / 16;
  if (VARIANT == kReg) {
    const int c = c0 + 4 * bx, nc = K - c;
    T v[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * by + i;
      if (r < S && nc > 0) load4(x + (size_t)r * K + c, nc, v[i]);
    }
    const int r = r0 + 4 * by, nr = S - r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c + j >= K || nr <= 0) continue;
      const T w[4] = {v[0][j], v[1][j], v[2][j], v[3][j]};
      store4(out + (size_t)(c + j) * S + r, nr, w);
    }
    return;
  }

  // staged: read x's rows into the tile, write out's rows from its columns;
  // thread (tx, ty) takes 4-element vectors of rows ty, ty + 16, ...
  const int tx = t % 16, ty = t / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i, r = r0 + lr, c = c0 + 4 * tx;
    T v[4] = {T(0), T(0), T(0), T(0)};
    if (r < S && c < K) load4(x + (size_t)r * K + c, K - c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) tile[staged<VARIANT>(lr, 4 * tx + e)] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lc = ty + 16 * i, c = c0 + lc, r = r0 + 4 * tx;
    if (c >= K || r >= S) continue;
    T v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = tile[staged<VARIANT>(4 * tx + e, lc)];
    store4(out + (size_t)c * S + r, S - r, v);
  }
}

template <class T, int VARIANT>
int launch_order(int order, const void* x, void* out, int S, int K,
                 unsigned blocks, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (order) {
    case kCol2Row:
      transpose_kernel<T, VARIANT, kCol2Row><<<blocks, kThreads, 0, st>>>(
          xt, ot, S, K);
      break;
    case kRow2Col:
      transpose_kernel<T, VARIANT, kRow2Col><<<blocks, kThreads, 0, st>>>(
          xt, ot, S, K);
      break;
    case kDiagonal:
      transpose_kernel<T, VARIANT, kDiagonal><<<blocks, kThreads, 0, st>>>(
          xt, ot, S, K);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_variant(int variant, int order, const void* x, void* out, int S,
                   int K, unsigned blocks, cudaStream_t st) {
  switch (variant) {
    case kScalar:
      return launch_order<T, kScalar>(order, x, out, S, K, blocks, st);
    case kReg:
      return launch_order<T, kReg>(order, x, out, S, K, blocks, st);
    case kShared:
      return launch_order<T, kShared>(order, x, out, S, K, blocks, st);
    case kSharedBcf:
      return launch_order<T, kSharedBcf>(order, x, out, S, K, blocks, st);
    case kSwizzled:
      return launch_order<T, kSwizzled>(order, x, out, S, K, blocks, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (K, S) = x (S, K)^T for elements of ``elem_bytes`` (1, 2 or 4) bytes;
// ``variant`` and ``order`` as in the enums above. Needs S, K > 0,
// contiguous x and out, and fewer than 2^31 tiles. Returns
// cudaGetLastError() after the launch (0 = launched) on ``stream``; does
// not synchronise and allocates nothing.
extern "C" int lc_transpose(const void* x, void* out, int S, int K,
                            int elem_bytes, int variant, int order,
                            void* stream) {
  if (S <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)((S + kTile - 1) / kTile) *
                          ((K + kTile - 1) / kTile);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(tiles);
  switch (elem_bytes) {
    case 1:
      return launch_variant<uint8_t>(variant, order, x, out, S, K, blocks, st);
    case 2:
      return launch_variant<uint16_t>(variant, order, x, out, S, K, blocks,
                                      st);
    case 4:
      return launch_variant<uint32_t>(variant, order, x, out, S, K, blocks,
                                      st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
