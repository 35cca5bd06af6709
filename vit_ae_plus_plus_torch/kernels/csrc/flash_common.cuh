// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the LayerNorm+Dense kernels (ln_dense.cu): the f32-accurate 3xTF32
// product on mma.sync m16n8k8, register packing and cp.async.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4;
// wgmma's A from registers takes this A layout, a warp's 16 rows each):
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g+8, k 2t..2t+1),
//                a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, k 2t+8..2t+9);
//   B (16 x 8):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g);
//   C (16 x 8):  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
// So the C accumulators of two neighbouring 8-column tiles, rounded to bf16,
// are exactly the A fragment of one 16-deep step.
//
// Fragment layouts of mma.sync.m16n8k8.row.col.tf32 (the same g and t):
//   A (16 x 8):  a0 = (row g, k t), a1 = (row g+8, k t),
//                a2 = (row g, k t+4), a3 = (row g+8, k t+4);
//   B (8 x 8):   b0 = (k t, col g), b1 = (k t+4, col g);
//   C (16 x 8):  as above.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ 3xTF32
// An f32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest (the tensor core reads only a tf32 value's top 19
// bits). x = hi + lo to about 2^-22 relative, and a product a * b becomes
// a.hi * b.hi + a.hi * b.lo + a.lo * b.hi, dropping a.lo * b.lo (about 2^-22
// relative): f32-accurate products on the TF32 tensor cores at a third of
// their rate, CUTLASS's OpMultiplyAddFastF32.

struct Tf32x2 {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_1688_tf32(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in f32 accuracy: the small terms first, then hi * hi.
__device__ __forceinline__ void mma_1688_3xtf32(float c[4], const uint32_t a_hi[4], const uint32_t a_lo[4],
                                                Tf32x2 b0, Tf32x2 b1) {
  mma_1688_tf32(c, a_lo, b0.hi, b1.hi);
  mma_1688_tf32(c, a_hi, b0.lo, b1.lo);
  mma_1688_tf32(c, a_hi, b0.hi, b1.hi);
}

// A fragment (hi and lo) of four f32 values in the m16n8k8 A order.
__device__ __forceinline__ void split_a(const float v[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32x2 s = split_tf32(v[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// ----------------------------------------------------------------- cp.async

// 16 bytes global -> shared, zero-filled when !valid (0 source bytes).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace flash
