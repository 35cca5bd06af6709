// Hopper (sm_90a) building blocks for warp-specialised kernels: mbarriers,
// TMA tensor loads (rank 2 to 4 tensor maps), wgmma shared-memory
// descriptors in both majors, the bf16 wgmma m64nNk16 (N = 32, 64, 128)
// with A from shared memory or from registers and B K-major or MN-major,
// and the tf32 wgmma m64nNk8 in the same forms (tf32 operands are K-major
// only); on the host the TMA descriptor of a bf16 or f32 tensor
// (cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library needs no -lcuda). Used by ln_dense.cu (the bf16 forward and dln
// product, and the f32 ones on 3xTF32), flash_fwd.cu (the bf16 forward) and
// flash_bwd.cu (the bf16 backward, and the f32 one on 3xTF32).
//
// A tf32 operand row of 32 values is 128 bytes, as a bf16 row of 64, and a
// k8 step spans 32 bytes of it, as a bf16 k16 step does: the K-major
// descriptors below serve both types unchanged.
//
// wgmma operands in shared memory sit in the swizzled layouts that TMA
// writes: rows of 128 bytes (SWIZZLE_128B: 16-byte chunk c of row r stored
// at chunk c ^ (r % 8)) or of 64 bytes (SWIZZLE_64B: chunk c ^ ((r / 2) %
// 4)), 8 rows to an atom (1,024 or 512 bytes), the swizzle taken from
// address bits, so every operand tile starts on a 1,024-byte boundary.
//   K-major (the operand's contiguous axis is the product's depth K): a
//   row holds K values of one M (or N) index. The descriptor names the
//   tile's start (advanced by 32 bytes per 16-deep step inside a row) and
//   the stride between 8-row atoms along M or N (SBO); the leading offset
//   is unused.
//   MN-major (the contiguous axis is M or N; wgmma's transpose flag set):
//   a row holds 64 (128B) or 32 (64B) values along N of one K index, so an
//   atom is 8 K indices deep. The descriptor's SBO is then the stride
//   between 8-deep groups along K (a 16-deep step spans two of them and
//   advances the start by 2 * SBO), and its LBO the stride between atom
//   columns along N (one atom column covers 64 or 32 values of N).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of TMA data on this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// wait that outlasts about 2^35 cycles (over 15 s) traps, so that a broken
// pipeline fails its launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

// ----------------------------------------------------------------------- TMA

// L2 cache policies for TMA loads: evict_last for an operand that every
// block reads again, evict_first for one read once.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Tile (c0, c1) of a 2-D tensor map (c0 the inner coordinate, in elements)
// into shared memory under the L2 `policy`; completion counts `bar`'s
// expected bytes down.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar,
                                            uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)),
      "l"(policy)
      : "memory");
}

// Tile (c0, c1, c2, c3) of a 4-D tensor map (c0 innermost, in elements).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                                            uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_descriptor(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Generic-proxy writes to shared memory (threads storing an operand) made
// visible to the async proxy (wgmma, TMA) before a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Register reallocation between warpgroups (all 128 threads of the
// warpgroup execute it): a producer warpgroup gives registers back to the
// pool, consumer warpgroups take them, up to N a thread.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1..15) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --------------------------------------------------------------------- wgmma

constexpr int kSwizzle128 = 1;  // descriptor layout types
constexpr int kSwizzle64 = 2;

// Descriptor of a K-major operand tile at `smem` (1,024-byte aligned atoms,
// plus a k offset of a multiple of 32 bytes), `sbo` bytes between 8-row
// atoms; the leading offset is unused for swizzled K-major tiles.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t sbo, int layout) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// Descriptor of an MN-major operand tile at `smem` (an atom boundary):
// `sbo` bytes between 8-deep groups along K, `lbo` bytes between atom
// columns along N (unused when N fits one atom column).
__device__ __forceinline__ uint64_t wgmma_desc_mn(const void* smem, uint32_t lbo, uint32_t sbo, int layout) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator accesses across an async wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The bf16 wgmma m64nNk16 with f32 accumulators: d (64 x N, this thread's
// N / 2) += A (64 x 16) * B (16 x N); with `accumulate` 0 the product
// overwrites d. `ss` reads A and B from shared memory behind descriptors (A
// K-major), `rs` takes A from registers (`a`: the m16n8k16 A fragment of
// the thread's warp, rows 16 * warp .. + 15 of the 64). TB = 1 marks B
// MN-major (the transpose flag; its descriptor from `wgmma_desc_mn`), 0
// K-major. Accumulator layout: d[4j + e] is row 16 * warp + lane / 4 (+ 8
// for e >= 2), column 8j + 2 * (lane % 4) + (e & 1).
#define SM90_ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  static constexpr int kRegs = 16;
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  static constexpr int kRegs = 32;
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  static constexpr int kRegs = 64;
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
  }
};

// The tf32 wgmma m64nNk8 (N = 32, 64, 128) with f32 accumulators: d (64 x
// N) += A (64 x 8) * B (8 x N), both operands K-major (tf32 has no transpose
// flag). `ss` reads A and B from shared memory behind descriptors, `rs`
// takes A from registers: `a` is the m16n8k8 tf32 A fragment of the
// thread's warp (rows 16 * warp .. + 15 of the 64): a0 = (row g, k t), a1 =
// (row g + 8, k t), a2 = (row g, k t + 4), a3 = (row g + 8, k t + 4), g =
// lane / 4, t = lane % 4, each a tf32 bit pattern (cvt.rna.tf32.f32). The
// accumulator layout is Wgmma<N>'s; `accumulate` 0 overwrites d.
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
  }
};

#undef SM90_ACC8

// d (64 x 128) += A (64 x 16) * B (16 x 128), both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int accumulate) {
  Wgmma<128>::ss<0>(d, desc_a, desc_b, accumulate);
}

// The register A fragment of 16-deep step kk from an m64nN f32 accumulator,
// rounded to bf16: a wgmma's output columns 16kk .. 16kk + 15 become the
// next product's depth (P or dS of attention, as the mma.sync bodies reuse
// their C fragments).
template <int R>
__device__ __forceinline__ void acc_to_a(const float (&acc)[R], int kk, uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = __floats2bfloat162_rn(acc[8 * kk + 2 * i], acc[8 * kk + 2 * i + 1]);
    a[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------- host

// A tensor map of elements of `type` and `rank` (2 to 5) dimensions at
// `base`: dims[i] elements along dimension i (0 innermost, contiguous),
// byte_strides[i] bytes between neighbours along dimension i + 1 (multiples
// of 16), boxes of box[i] elements, swizzled as `swizzle`; reads past the
// dims are zero-filled. -> CUDA_SUCCESS or the encoder's error.
inline CUresult encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                       const uint64_t* dims, const uint64_t* byte_strides, const uint32_t* box,
                       CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode_fn = nullptr;
  if (encode_fn == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return CUDA_ERROR_NOT_FOUND;
    }
    encode_fn = reinterpret_cast<Encode>(fn);
  }
  if (rank < 2 || rank > 5) return CUDA_ERROR_INVALID_VALUE;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) st[i] = byte_strides[i];
  }
  return encode_fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, st, bx, es,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

inline CUresult encode_bf16(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
                            const uint64_t* byte_strides, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, byte_strides, box, swizzle);
}

// A 2-D tensor map over a row-major (rows, cols) array of `elt`-byte
// elements of `type` at `base`, boxes of box_rows x box_cols.
inline CUresult encode_2d(CUtensorMap* map, CUtensorMapDataType type, uint64_t elt, const void* base, uint64_t rows,
                          uint64_t cols, uint32_t box_rows, uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows};
  const uint64_t strides[1] = {cols * elt};
  const uint32_t box[2] = {box_cols, box_rows};
  return encode(map, type, base, 2, dims, strides, box, swizzle);
}

inline CUresult encode_bf16_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, uint32_t box_rows,
                               uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rows, cols, box_rows, box_cols, swizzle);
}

inline CUresult encode_f32_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols, uint32_t box_rows,
                              uint32_t box_cols, CUtensorMapSwizzle swizzle) {
  return encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, rows, cols, box_rows, box_cols, swizzle);
}

}  // namespace sm90
