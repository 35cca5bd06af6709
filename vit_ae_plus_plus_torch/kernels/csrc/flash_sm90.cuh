// The 64-row bf16 tiles that the flash-attention wgmma bodies stream with
// TMA (flash_fwd.cu's forward, flash_bwd.cu's dK/dV and dQ kernels): their
// shared-memory geometry, their wgmma descriptors in both majors, their
// rank-4 tensor maps over (d, token, head, batch), and the exp2 the softmax
// runs on. Then the f32 bodies' 3xTF32 building blocks, which the f32
// forward (flash_fwd.cu) and the f32 backward (flash_bwd.cu) share: the
// split copies' token permutation, tf32 descriptors and loads, and the
// score and chunk products.
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

// ------------------------------------------------------- 3xTF32 on tf32 wgmma
//
// The f32 bodies split each operand into tf32 hi and lo copies (a pre-pass
// into scratch the wrapper allocates; the forward's Q in shared memory,
// where it stays resident) and run every product as
// 3xTF32 on tf32 wgmma (flash_common.cuh: hi * hi + hi * lo + lo * hi, lo
// * lo dropped). Operand tiles are f32 (tf32 bit patterns) in k-blocks of
// 32 columns: 128-byte rows swizzled 128B, 8-row atoms of 1,024 bytes, one
// K-major descriptor per k8 step (32 bytes further along the row); a
// transposed tile of 16 tokens has 64-byte rows swizzled 64B. tf32 wgmma
// reads only K-major shared operands, so a product whose depth is the
// token axis (P V, dS K, P^T dO, dS^T Q) reads a transposed copy (D rows of
// tokens) whose 8-token groups are permuted (tf32_token): the order in
// which an accumulator's columns land as a tf32 A fragment
// (acc_to_tf32_a), so P or dS go from the accumulator to the A operand with
// no shuffle.

constexpr int kTfRows = 32;  // tokens a block of a split pre-pass

// The token a transposed copy holds at position p of an 8-token group: t at
// p = t, 2t + 1 at p = t + 4 (t < 4), where a wgmma accumulator's column
// lands when its registers are read as a tf32 A fragment (acc_to_tf32_a).
__host__ __device__ constexpr int tf32_token(int p) { return 2 * (p & 3) + (p >> 2); }

__host__ __device__ inline long long pad8(int n) { return (n + 7) / 8 * 8; }

// K-major descriptor of k8 step kk of an R-row f32 tile (k-blocks of R x
// 32 floats).
template <int R>
__device__ __forceinline__ uint64_t desc_tf32(const unsigned char* tile, int kk) {
  return sm90::wgmma_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 1024, sm90::kSwizzle128);
}

// K-major descriptor of k8 step kk of a transposed tile, D rows of T
// tokens: T a multiple of 32 is desc_tf32<D>'s layout (k-blocks of 32
// tokens, D rows each); T = 16 is 64-byte rows swizzled 64B, 512-byte
// atoms, as TMA writes a 16-token box.
template <int D, int T>
__device__ __forceinline__ uint64_t desc_tf32_t(const unsigned char* tile, int kk) {
  if constexpr (T % 32 == 0) {
    return desc_tf32<D>(tile, kk);
  } else {
    static_assert(T == 16, "a transposed tile holds 16 tokens or a multiple of 32");
    return sm90::wgmma_desc(tile + kk * 32, 512, sm90::kSwizzle64);
  }
}

// Rows row0 .. row0 + R - 1 of half hl (0 hi, 1 lo) of head bh of a split
// copy (2, BH, rows, D) into an R-row tile; rows past the copy arrive as
// zeros. A transposed copy (2, BH, D, np) is one box of D rows of tokens
// at (tok0, 0, bh, hl).
template <int D, int R>
__device__ __forceinline__ void load_split_rows(unsigned char* tile, const CUtensorMap* map, int row0, int bh, int hl,
                                                uint64_t* bar, uint64_t policy) {
#pragma unroll
  for (int kb = 0; kb < D / 32; ++kb) sm90::tma_load_4d(tile + kb * R * 128, map, kb * 32, row0, bh, hl, bar, policy);
}

// The tf32 A fragment, hi and lo, of k8 step kk from an m64nN accumulator:
// the thread's columns 8kk + 2t and 8kk + 2t + 1 of rows g and g + 8 become
// depth positions t and t + 4, the order the transposed copies hold the
// tokens in (tf32_token), so each register moves as it lies. ALU: the
// split on the integer and FMA pipes (split_tf32_alu), not cvt.
template <int R, bool ALU = false>
__device__ __forceinline__ void acc_to_tf32_a(const float (&acc)[R], int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {acc[4 * kk], acc[4 * kk + 2], acc[4 * kk + 1], acc[4 * kk + 3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Tf32x2 s = ALU ? split_tf32_alu(v[i]) : split_tf32(v[i]);
    hi[i] = s.hi;
    lo[i] = s.lo;
  }
}

// d (64 x N) = A B^T as 3xTF32 over k8 steps K0 .. K1 - 1 of D, one
// accumulator: A (64 x D) and B (N x D) K-major in shared memory, hi and lo
// tiles each (S, S^T, dP^T and dP; the first product overwrites d).
template <int D, int N, int K0 = 0, int K1 = D / 8>
__device__ __forceinline__ void scores_3xtf32(float (&d)[N / 2], const unsigned char* a_hi, const unsigned char* a_lo,
                                              const unsigned char* b_hi, const unsigned char* b_lo) {
#pragma unroll
  for (int kk = K0; kk < K1; ++kk) {
    sm90::WgmmaTf32<N>::ss(d, desc_tf32<kBlock>(a_lo, kk), desc_tf32<N>(b_hi, kk), kk > K0);
    sm90::WgmmaTf32<N>::ss(d, desc_tf32<kBlock>(a_hi, kk), desc_tf32<N>(b_lo, kk), 1);
    sm90::WgmmaTf32<N>::ss(d, desc_tf32<kBlock>(a_hi, kk), desc_tf32<N>(b_hi, kk), 1);
  }
}

// A score product over all of D into d; at d = 128 over its first 64 dims
// into d and its last 64 into d2, two fresh accumulators (one over all 128
// would truncate twice as often at a larger magnitude: the CPU witness reads
// the error halved), which `scores_join` adds after the wait.
template <int D, int N>
__device__ __forceinline__ void scores_split(float (&d)[N / 2], float (&d2)[N / 2], const unsigned char* a_hi,
                                             const unsigned char* a_lo, const unsigned char* b_hi,
                                             const unsigned char* b_lo) {
  if constexpr (D == 128) {
    scores_3xtf32<D, N, 0, 8>(d, a_hi, a_lo, b_hi, b_lo);
    scores_3xtf32<D, N, 8, 16>(d2, a_hi, a_lo, b_hi, b_lo);
  } else {
    scores_3xtf32<D, N>(d, a_hi, a_lo, b_hi, b_lo);
  }
}

template <int D, int N>
__device__ __forceinline__ void scores_join(float (&d)[N / 2], float (&d2)[N / 2]) {
  sm90::fence_operands(d);
  if constexpr (D == 128) {
    sm90::fence_operands(d2);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] += d2[i];
  }
}

// d (64 x D) = A B over one T-deep stage as 3xTF32 into a fresh
// accumulator: A from registers (T / 8 k8 steps, hi and lo), B a transposed
// D-row tile of T tokens (hi and lo) whose token order matches A's (P V,
// dV, dK and dQ).
template <int D, int T>
__device__ __forceinline__ void chunk_3xtf32(float (&d)[D / 2], const uint32_t (&a_hi)[T / 8][4],
                                             const uint32_t (&a_lo)[T / 8][4], const unsigned char* b_hi,
                                             const unsigned char* b_lo) {
#pragma unroll
  for (int kk = 0; kk < T / 8; ++kk) {
    sm90::WgmmaTf32<D>::rs(d, a_lo[kk], desc_tf32_t<D, T>(b_hi, kk), kk > 0);  // a fresh accumulator per chunk
    sm90::WgmmaTf32<D>::rs(d, a_hi[kk], desc_tf32_t<D, T>(b_lo, kk), 1);
    sm90::WgmmaTf32<D>::rs(d, a_hi[kk], desc_tf32_t<D, T>(b_hi, kk), 1);
  }
}

// A rank-4 tensor map over a split copy (2, BH, rows, cols) of f32, boxes of
// box_rows x box_cols (32 columns: 128-byte rows swizzled 128B; 16: 64-byte
// rows swizzled 64B).
inline CUresult encode_split(CUtensorMap* map, const float* base, long long bh, long long rows, long long cols,
                             int box_rows, int box_cols = 32) {
  const uint64_t dims[4] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows), static_cast<uint64_t>(bh), 2};
  const uint64_t strides[3] = {static_cast<uint64_t>(cols) * 4, static_cast<uint64_t>(rows * cols) * 4,
                               static_cast<uint64_t>(bh * rows * cols) * 4};
  const uint32_t box[4] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows), 1, 1};
  return sm90::encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 4, dims, strides, box,
                      box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace flash
