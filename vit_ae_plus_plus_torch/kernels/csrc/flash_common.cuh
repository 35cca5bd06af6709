// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and the LayerNorm kernels (layernorm.cu, ln_dense.cu): constants, register
// packing and the tf32 split of the f32-accurate 3xTF32 products.
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
// Fragment layouts of mma.sync.m16n8k8.row.col.tf32 (the same g and t;
// tf32 wgmma's A from registers takes this A layout):
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
// their rate, CUTLASS's OpMultiplyAddFastF32. The products run on tf32
// wgmma (flash_sm90.cuh, ln_dense.cu).

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

// The same split of a finite x for a register operand, on the integer and
// FMA pipes (cvt.rna costs more, and a softmax splits 4,096 values a
// stage): hi rounded to nearest, ties away, by an add and a mask (cvt.rna's
// result), lo = x - hi exact and unrounded, since the tensor core reads its
// top 19 bits (lo truncated: 2^-11 of lo, 2^-22 of x).
__device__ __forceinline__ Tf32x2 split_tf32_alu(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

}  // namespace flash
