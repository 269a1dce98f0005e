// Hopper's datapath in PTX (sm_90a), for the kernels that feed the tensor
// cores by TMA and wgmma: mbarriers, 2-D TMA loads (plain and multicast to
// a cluster) and stores, wgmma with shared-memory descriptors, register
// reallocation, proxy fences, the device-scope flags a persistent walk waits
// on, and the host-side tensor maps. First used by the resident chain
// (matmul_resident.cu); the base for the later speed slices. The flash
// backward (flash_bwd.cu) adds 3-D maps and loads, 1-D bulk copies, a
// barrier test that does not wait, wgmma with B K-major or A in registers,
// and named barriers; the flash forward (flash_fwd.cu) and the w4a16 matmul
// (w4_matmul.cu) share its ring of stages, descriptors and approximations,
// and the w4a16 matmul adds wgmma at N = 8 and 16 and byte-tile maps. The
// dense matmul's kernel (gemm_sm90.cuh, which the resident chain now runs
// on) adds f16 inputs to the SS wgmma.
//
// Conventions:
// - A tile that TMA writes with the 128-byte swizzle is a stack of rows of
//   128 bytes (64 16-bit values), the 16-byte chunks of row r XOR-ed with
//   r % 8; its base is 1024-byte aligned, so that the swizzle pattern
//   starts at row 0 and descriptors need no base offset.
// - Every wait is bounded: past kSpinNs of the global timer the thread
//   traps, so a protocol fault ends the launch with an error instead of
//   hanging the card.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace lc {
namespace sm90 {

constexpr unsigned long long kSpinNs = 10ull * 1000 * 1000 * 1000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the cluster (and to TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also expects ``bytes`` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival on the barrier at ``bar``'s offset in CTA ``cta`` of the
// cluster (this CTA's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n\t}"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// Whether the phase of parity ``parity`` has completed, without waiting.
__device__ __forceinline__ bool mbar_test_wait(uint64_t* bar,
                                               uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

// Wait until the phase of parity ``parity`` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kSpinNs) __trap();
}

// ------------------------------------------------------------------- TMA

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box of ``map`` at (c0 inner, c1 outer) into shared memory at ``dst``,
// its bytes counted on ``bar``. Elements past the tensor's bounds read 0.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst`` (both
// 16-byte aligned), counted on ``bar``: a 1-D bulk copy, no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of a 3-D ``map`` at (c0 inner, c1, c2 outer); elements past the
// tensor's bounds read 0 (so a box of rows past the end of one matrix of
// the stack reads zeros, never the next matrix's rows).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same box written at ``dst``'s offset in every CTA of ``mask`` (bit c:
// CTA c of the cluster), its bytes counted on the barrier at ``bar``'s
// offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(
    void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// The box of ``map`` at (c0 inner, c1 outer) written from shared memory at
// ``src`` (laid out as a load of the same box would leave it); elements past
// the tensor's bounds are not written. One bulk group per commit_bulk.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}
__device__ __forceinline__ void commit_bulk() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's bulk groups are pending: their
// shared-memory sources read (kRead) or their writes complete.
template <int N, bool kRead>
__device__ __forceinline__ void wait_bulk() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// Orders this thread's generic-proxy accesses to global memory with the
// async proxy's (TMA), both ways: where rows that one proxy wrote are read
// by the other, or a flag in one releases writes of the other.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// The same for shared memory: plain stores into a tile that a TMA store
// then reads.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ----------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units in the fields).
// K-major tiles (rows of 64 values along k): lbo unused (16), sbo = 1024,
// the stride between groups of 8 rows. MN-major tiles (rows of 64 values
// along m or n, one row per k): lbo = the stride between 64-wide chunks
// along m or n, sbo = 1024, between groups of 8 k-rows.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// the wgmma fence / wait around it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// ------------------------------------- wgmma: both B layouts, A in registers
//
// wgmma_ss_bf16<kTnspB>: D (64 x N, f32) (+)= A (64 x 16, K-major,
// descriptor ``da``) @ B (16 x N, descriptor ``db``), bf16 inputs
// (wgmma_ss_f16: f16 inputs). kTnspB 0 reads B K-major (N rows of 16
// values along k: K for Q K^T, as stored), 1 MN-major (16 k-rows of N
// values: V for P V, as stored). wgmma_rs_bf16
// is the same with A from registers: thread t of the warpgroup holds
// A[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e] in the half e
// of a[2 j + h], the layout of columns [16 kk, 16 kk + 16) of an m64
// accumulator (d[8 kk + 4 j + 2 h + e]), so an accumulator rounded to
// bf16 feeds the next product without passing through shared memory.
// N is 8, 16, 32, 64, 128 or 256 (N / 2 accumulators a thread); ``acc`` 0
// overwrites D.

#define LC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define LC_D16(i) LC_D4(i), LC_D4(i + 4), LC_D4(i + 8), LC_D4(i + 12)
#define LC_D64(i) LC_D16(i), LC_D16(i + 16), LC_D16(i + 32), LC_D16(i + 48)
#define LC_S16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15"
#define LC_S32 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31"
#define LC_S64 \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, " \
  "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63"
#define LC_S128 \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, " \
  "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, " \
  "%102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, " \
  "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127"

// The SS and RS wrappers of one N: NF accumulators, their register list
// REGS, then the operands' numbers (A0-A6) and the accumulators'
// constraints (the variadic part).
#define LC_WGMMA_PAIR(N, NF, REGS, A0, A1, A2, A3, A4, A5, A6, ...)          \
  template <int kTnspB>                                                      \
  __device__ __forceinline__ void wgmma_ss_bf16(float(&d)[NF], uint64_t da,  \
                                                uint64_t db, int acc) {      \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %" #A2 ", 0;\n\t"    \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" REGS "}, %" #A0 ", %" #A1             \
                 ", p, 1, 1, 0, %" #A3 ";\n\t}"                              \
                 : __VA_ARGS__                                               \
                 : "l"(da), "l"(db), "r"(acc), "n"(kTnspB));                 \
  }                                                                          \
  template <int kTnspB>                                                      \
  __device__ __forceinline__ void wgmma_ss_f16(float(&d)[NF], uint64_t da,   \
                                               uint64_t db, int acc) {       \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %" #A2 ", 0;\n\t"    \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.f16.f16 {" REGS "}, %" #A0 ", %" #A1               \
                 ", p, 1, 1, 0, %" #A3 ";\n\t}"                              \
                 : __VA_ARGS__                                               \
                 : "l"(da), "l"(db), "r"(acc), "n"(kTnspB));                 \
  }                                                                          \
  template <int kTnspB>                                                      \
  __device__ __forceinline__ void wgmma_rs_bf16(                             \
      float(&d)[NF], const uint32_t(&a)[4], uint64_t db, int acc) {          \
    asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %" #A5 ", 0;\n\t"    \
                 "wgmma.mma_async.sync.aligned.m64n" #N                      \
                 "k16.f32.bf16.bf16 {" REGS "}, {%" #A0 ", %" #A1            \
                 ", %" #A2 ", %" #A3 "}, %" #A4 ", p, 1, 1, %" #A6           \
                 ";\n\t}"                                                    \
                 : __VA_ARGS__                                               \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                   "r"(acc), "n"(kTnspB));                                   \
  }

LC_WGMMA_PAIR(8, 4, "%0, %1, %2, %3", 4, 5, 6, 7, 8, 9, 10, LC_D4(0))
LC_WGMMA_PAIR(16, 8, "%0, %1, %2, %3, %4, %5, %6, %7", 8, 9, 10, 11, 12, 13,
              14, LC_D4(0), LC_D4(4))
LC_WGMMA_PAIR(32, 16, LC_S16, 16, 17, 18, 19, 20, 21, 22, LC_D16(0))
LC_WGMMA_PAIR(64, 32, LC_S16 ", " LC_S32, 32, 33, 34, 35, 36, 37, 38,
              LC_D16(0), LC_D16(16))
LC_WGMMA_PAIR(128, 64, LC_S16 ", " LC_S32 ", " LC_S64, 64, 65, 66, 67, 68,
              69, 70, LC_D64(0))
LC_WGMMA_PAIR(256, 128, LC_S16 ", " LC_S32 ", " LC_S64 ", " LC_S128, 128,
              129, 130, 131, 132, 133, 134, LC_D64(0), LC_D64(64))

#undef LC_WGMMA_PAIR

// wgmma_ss_bf16 or wgmma_ss_f16 by the input type (N from the accumulator).
template <bool kF16, int kTnspB, int NF>
__device__ __forceinline__ void wgmma_ss(float (&d)[NF], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (kF16)
    wgmma_ss_f16<kTnspB>(d, da, db, acc);
  else
    wgmma_ss_bf16<kTnspB>(d, da, db, acc);
}
#undef LC_D4
#undef LC_D16
#undef LC_D64
#undef LC_S16
#undef LC_S32
#undef LC_S64
#undef LC_S128

// All threads of the ``threads`` (a multiple of 32) that use named barrier
// ``id`` (1-15; 0 is __syncthreads').
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}
// This thread's arrival at named barrier ``id`` without waiting.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------- descriptors, fences, approximations

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// A K-major descriptor of a 128-byte swizzled tile (rows of 64 values along
// k, 8-row groups 1024 bytes apart) and an MN-major one (k-rows of 64
// values along m or n, 64-wide chunks ``chunk`` bytes apart).
__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return gmma_desc(addr, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, uint32_t chunk) {
  return gmma_desc(addr, chunk, 1024);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(a[i]);
}
// Keeps A fragments that an RS wgmma in flight reads in their registers
// until the wait that retires it.
template <int N, int W>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[N][W]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < W; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// tanh in one MUFU op (the softcap's: tanhf took the cap-50 backward 23%
// longer, and the approximation holds every cap check and control).
__device__ __forceinline__ float tanh_cap(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 2^x in one MUFU op (flushing results below 2^-126 to 0, which no
// tolerance of a P in [0, 1] sees); exp2f adds range handling around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------------------ ring

// A ring of stages: tile i of a walk goes to stage i % kStages behind
// full[stage], an mbarrier that counts its bytes. Each of the kWarps
// consumer warps releases a stage once its reads of it are done; the warp
// whose release completes the stage (a counter in shared memory) issues
// tile i + kStages into it at once, so a load starts as early as its stage
// is free. (A producer warp beside two consumer warpgroups would make a
// block of 9 warps, which caps every thread at 168 registers: the SM's four
// register partitions hold 3 of its warps in one.)
template <int kStages, int kWarps>
struct Ring {
  uint64_t* full;
  int* released;  // [kStages]
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
  }
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  }
  // the first tiles, one thread
  template <class Issue>
  __device__ __forceinline__ void start(int n, Issue&& issue) const {
    for (int i = 0; i < kStages && i < n; ++i) issue(i, i, &full[i]);
  }
  // this warp is done with tile i (lane 0 counts it)
  template <class Issue>
  __device__ __forceinline__ void release(int i, int n, int lane,
                                          Issue&& issue) const {
    if (lane != 0) return;
    const int s = i % kStages;
    __threadfence_block();  // this warp's reads before its count
    if (atomicAdd(&released[s], 1) == kWarps - 1) {
      released[s] = 0;
      __threadfence_block();
      fence_proxy_async_shared();  // the stage's readers before TMA's writes
      if (i + kStages < n) issue(i + kStages, s, &full[s]);
    }
  }
};

// ------------------------------------------- warpgroups, clusters, flags

// Give this warpgroup's registers back (producer) or take them (consumers);
// every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(N));
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void red_release_gpu_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Spin (one thread) until *flag >= target, with acquire semantics.
__device__ __forceinline__ void wait_flag_at_least(const int* flag,
                                                   int target) {
  if (ld_acquire_gpu(flag) >= target) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire_gpu(flag) < target) {
    if (global_ns() - t0 > kSpinNs) __trap();
    __nanosleep(64);
  }
}

// ------------------------------------------------------------- host side

// cuTensorMapEncodeTiled, found through the runtime, so that the library
// needs no -lcuda. Null if the driver does not have it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major (rows, cols) matrix of 16-bit values, ``ld`` values a row (a
// multiple of 8), read in boxes of box_rows x box_cols (box_cols * 2 <=
// 128 bytes) with the 128-byte swizzle; out-of-range elements read 0.
// Returns a CUDA error code (0 = encoded).
inline int map_2d(CUtensorMap* map, const void* ptr, bool f16, int rows,
                  int cols, int ld, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         2, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A row-major (rows, cols) matrix of bytes, ``ld`` bytes a row (a multiple
// of 16), read in boxes of box_rows x box_cols (box_cols <= 128) with the
// 128-byte swizzle; out-of-range bytes read 0. Returns a CUDA error code.
inline int map_2d_u8(CUtensorMap* map, const void* ptr, int rows, int cols,
                     int ld, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A stack of ``depth`` row-major (rows, cols) matrices of bf16 (f16 with
// ``f16``), contiguous ((depth, rows, cols), cols a multiple of 8), read in
// boxes of box_rows x box_cols (box_cols * 2 <= 128 bytes) of one matrix
// with the 128-byte swizzle; out-of-range elements read 0. Returns a CUDA
// error code.
inline int map_3d(CUtensorMap* map, const void* ptr, bool f16, int depth,
                  int rows, int cols, int box_rows, int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r =
      fn(map, f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         3, const_cast<void*>(ptr), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
}  // namespace lc
