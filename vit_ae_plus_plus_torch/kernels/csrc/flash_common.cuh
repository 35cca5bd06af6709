// Helpers shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the bf16 tensor-core product mma.sync m16n8k16, register packing, and the
// staging of a tile of rows into shared memory.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g+8, k 2t..2t+1),
//                a2 = (row g, k 2t+8..2t+9), a3 = (row g+8, k 2t+8..2t+9);
//   B (16 x 8):  b0 = (k 2t..2t+1, col g), b1 = (k 2t+8..2t+9, col g);
//   C (16 x 8):  c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, same).
// So the C accumulators of two neighbouring 8-column tiles, rounded to bf16,
// are exactly the A fragment of one 16-deep step.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of 16 rows from shared memory: `base` points at (row g, col 2t)
// of the first row of the fragment, rows LD apart; `k` is the 16-deep step.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* base, int k) {
  a[0] = ld32(base + k * 16);
  a[1] = ld32(base + k * 16 + 8 * LD);
  a[2] = ld32(base + k * 16 + 8);
  a[3] = ld32(base + k * 16 + 8 * LD + 8);
}

// Rows [row0, row0 + ROWS) of one head into shared memory (row pitch LD),
// by THREADS threads with 16-byte loads; rows at or past n are zero-filled.
template <int D, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

}  // namespace flash
