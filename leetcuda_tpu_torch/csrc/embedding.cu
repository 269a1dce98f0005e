// Embedding gather for Hopper: out[s, :] = table[clamp(idx[s], 0, V - 1), :]
// for a table of V rows of ``row_bytes`` bytes each, ids int32 or int64.
//
// Replaces: leetcuda_tpu/ops/embedding.py make_embedding
// (_embedding_kernel) and make_embedding_tiled (_embedding_tiled_kernel).
// The tiled factory gathers from the (V, D / 128, 128) "serving layout",
// which in row-major memory is the same bytes as (V, D): the port calls
// this one kernel on that view.
//
// Bound on an H100 SXM: bytes. Each gathered row is read once and written
// once (16384 ids of a (32000, 2048) bf16 table: 134 MB, 40 us at 3.35
// TB/s). Design: a CTA of 128 threads takes one id, clamps it as the TPU
// kernel does (jnp.clip), and copies the row in words of W bytes (the
// rung's load width: 2, 4 or 16; the wrapper narrows it until the row
// length and both base addresses are multiples of it), consecutive threads
// on consecutive words. The copy moves bits: 16-bit tables as raw 16-bit
// words, so a NaN payload arrives unchanged. The TPU kernel's 8-row DMA
// groups are HBM tiling and do not carry over.
#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int W>
struct Word;
template <>
struct Word<1> { using type = uint8_t; };
template <>
struct Word<2> { using type = uint16_t; };
template <>
struct Word<4> { using type = uint32_t; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

template <int W, class I>
__global__ void __launch_bounds__(kThreads)
embedding_kernel(const I* __restrict__ idx, const void* __restrict__ table,
                 void* __restrict__ out, long long V, long long row_bytes) {
  using T = typename Word<W>::type;
  const long long s = blockIdx.x;
  long long r = static_cast<long long>(idx[s]);
  r = r < 0 ? 0 : (r > V - 1 ? V - 1 : r);
  const long long n = row_bytes / W;
  const T* src = reinterpret_cast<const T*>(
      static_cast<const uint8_t*>(table) + r * row_bytes);
  T* dst = reinterpret_cast<T*>(static_cast<uint8_t*>(out) + s * row_bytes);
  for (long long i = threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <class I>
int launch(int word, const void* idx, const void* table, void* out, int S,
           long long V, long long row_bytes, cudaStream_t st) {
  const I* ids = static_cast<const I*>(idx);
  switch (word) {
    case 1:
      embedding_kernel<1, I><<<S, kThreads, 0, st>>>(ids, table, out, V,
                                                      row_bytes);
      break;
    case 2:
      embedding_kernel<2, I><<<S, kThreads, 0, st>>>(ids, table, out, V,
                                                      row_bytes);
      break;
    case 4:
      embedding_kernel<4, I><<<S, kThreads, 0, st>>>(ids, table, out, V,
                                                      row_bytes);
      break;
    case 8:
      embedding_kernel<8, I><<<S, kThreads, 0, st>>>(ids, table, out, V,
                                                      row_bytes);
      break;
    case 16:
      embedding_kernel<16, I><<<S, kThreads, 0, st>>>(ids, table, out, V,
                                                       row_bytes);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (S, row_bytes) = the rows of ``table`` (V rows of ``row_bytes``) at
// ``idx`` (S ids, int64 if ``idx64`` else int32), each clamped to [0, V - 1],
// copied in words of ``word`` bytes (1, 2, 4, 8 or 16; row_bytes and both
// base addresses multiples of it). Needs 0 < S < 2^31 and V > 0. Returns
// cudaGetLastError() after the launch (0 = launched) on ``stream``; does not
// synchronise and allocates nothing.
extern "C" int lc_embedding(const void* idx, int idx64, const void* table,
                            void* out, int S, long long V,
                            long long row_bytes, int word, void* stream) {
  if (S <= 0 || V <= 0 || row_bytes <= 0 || word <= 0 ||
      row_bytes % word != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return idx64 ? launch<int64_t>(word, idx, table, out, S, V, row_bytes, st)
               : launch<int32_t>(word, idx, table, out, S, V, row_bytes, st);
}
