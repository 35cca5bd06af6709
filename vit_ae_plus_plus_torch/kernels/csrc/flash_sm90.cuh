// The 64-row bf16 tiles that the flash-attention wgmma bodies stream with
// TMA (flash_fwd.cu's forward, flash_bwd.cu's dK/dV and dQ kernels): their
// shared-memory geometry, their wgmma descriptors in both majors, their
// rank-4 tensor maps over (d, token, head, batch), and the exp2 the softmax
// runs on.
//
// A tile is 64 rows of D bf16, as TMA writes it: k-blocks of 64 columns
// (128-byte rows, swizzled 128B; D = 32 is one block of 64-byte rows,
// swizzled 64B), each of 64 rows. The same tile serves K-major (its rows
// are a product's M or N, D its depth) and MN-major (its rows are the
// depth, D the N). Ragged tails arrive zero-filled from TMA.
#pragma once

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace flash {

constexpr int kBlock = 64;  // rows of every tile
constexpr int kWsThreads = 128 + 32;  // a block of one consumer warpgroup and one producer warp

// The tile geometry above, and the backward kernels' ring and shared-memory
// layout (flash_bwd.cu).
template <int D>
struct BwdTiling {
  static constexpr int kBoxCols = D < 64 ? D : 64;
  static constexpr int kKBlocks = D / kBoxCols;
  static constexpr int kSwizzle = D == 32 ? sm90::kSwizzle64 : sm90::kSwizzle128;
  static constexpr uint32_t kAtomBytes = kBoxCols * 2 * 8;  // 8 rows
  static constexpr int kBoxBytes = kBlock * kBoxCols * 2;   // one k-block of a tile
  static constexpr int kTileBytes = kBlock * D * 2;
  static constexpr int kStages = D == 32 ? 4 : (D == 64 ? 3 : 2);
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;  // blocks an SM holds: the register budget
  // [two resident tiles][kStages x two streamed tiles][kStages x 2 x 64
  // f32 (lse and delta, or the key bias)][barriers], after 1,024 bytes of
  // alignment room
  static constexpr int kRowsOffset = (2 + 2 * kStages) * kTileBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kBlock * 4;
  static constexpr int kSmem = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kSmem * kMinBlocks <= 228 * 1024, "over the shared memory of an SM");
};

// K-major descriptor of a tile's 16-deep step kk over D.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int kk) {
  using T = BwdTiling<D>;
  return sm90::wgmma_desc(tile + (kk * 16 / T::kBoxCols) * T::kBoxBytes + (kk * 16 % T::kBoxCols) * 2,
                          T::kAtomBytes, T::kSwizzle);
}

// MN-major descriptor of a tile's 16-deep step kk over its rows.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int kk) {
  using T = BwdTiling<D>;
  return sm90::wgmma_desc_mn(tile + kk * 2 * T::kAtomBytes, T::kBoxBytes, T::kAtomBytes, T::kSwizzle);
}

// Rows row0 .. row0 + 63 of head (b, h) of a 4-D (D, token, head, batch)
// tensor map into `tile`; rows past the tensor arrive as zeros.
template <int D>
__device__ __forceinline__ void load_rows(unsigned char* tile, const CUtensorMap* map, int row0, int h, int b,
                                          uint64_t* bar, uint64_t policy) {
  using T = BwdTiling<D>;
#pragma unroll
  for (int kb = 0; kb < T::kKBlocks; ++kb) {
    sm90::tma_load_4d(tile + kb * T::kBoxBytes, map, kb * T::kBoxCols, row0, h, b, bar, policy);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps registers that an async wgmma reads (register A fragments) live
// and unchanged until its wait.
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// The rank-4 (D, token, head, batch) tensor map of one bf16 operand from
// its element strides, boxes of 64 rows by one k-block.
template <int D>
CUresult encode_rows(CUtensorMap* map, const void* ptr, long long sb, long long sn, long long sh, int rows,
                     int heads, int batch) {
  using T = BwdTiling<D>;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(rows), static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sn) * 2, static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(T::kBoxCols), static_cast<uint32_t>(kBlock), 1, 1};
  return sm90::encode_bf16(map, ptr, 4, dims, strides, box,
                           D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace flash
