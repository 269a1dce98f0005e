// Vector loads and stores of the op corpus's flat passes (elementwise.cu,
// reduce.cu, histogram.cu): N elements a thread, in words of LB bytes where
// the address allows, element by element otherwise; and the split of a flat
// array into a scalar head, whole vectors and a scalar tail.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lc {

template <int LB>
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

// The N elements at p, raw: in loads of LB bytes where p is LB-aligned, else
// one element at a time.
template <class T, int N, int LB>
__device__ __forceinline__ void load_raw(const T* p, T (&v)[N]) {
  constexpr int PER = LB / static_cast<int>(sizeof(T));
  if constexpr (PER > 1 && N % PER == 0) {
    using U = typename Word<LB>::type;
    if (reinterpret_cast<uintptr_t>(p) % LB == 0) {
#pragma unroll
      for (int i = 0; i < N / PER; ++i) {
        const U u = reinterpret_cast<const U*>(p)[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < PER; ++j) v[i * PER + j] = e[j];
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = p[i];
}

template <class T, int N, int LB>
__device__ __forceinline__ void store_raw(T* p, const T (&v)[N]) {
  constexpr int PER = LB / static_cast<int>(sizeof(T));
  if constexpr (PER > 1 && N % PER == 0) {
    using U = typename Word<LB>::type;
    if (reinterpret_cast<uintptr_t>(p) % LB == 0) {
#pragma unroll
      for (int i = 0; i < N / PER; ++i) {
        U u;
        T* e = reinterpret_cast<T*>(&u);
#pragma unroll
        for (int j = 0; j < PER; ++j) e[j] = v[i * PER + j];
        reinterpret_cast<U*>(p)[i] = u;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// A flat array of n elements of ``size`` bytes at ``p`` as head elements up
// to the first LB-aligned address, then whole vectors of VEC elements, then
// the tail past the last whole vector. head < LB / size, so a CTA's first
// threads can take the head and the tail (< LB / size + VEC elements).
struct Split {
  long long head, nvec, tail;  // tail: the index of the first tail element
};

inline Split split_flat(const void* p, long long n, int size, int vec,
                        int lb) {
  const long long e = lb / size;  // elements per aligned load
  const long long mis =
      static_cast<long long>(reinterpret_cast<uintptr_t>(p) / size) % e;
  Split s;
  s.head = (e - mis) % e;
  if (s.head > n) s.head = n;
  s.nvec = (n - s.head) / vec;
  s.tail = s.head + s.nvec * vec;
  return s;
}

}  // namespace lc
