// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (vit_ae_plus_plus_torch/kernels/_build.py).
//
// Replaces three TPU kernels of the JAX package:
//   - vit_ae_plus_plus_tpu/kernels/packed_flash.py::_packed_bwd
//     (_pk_bwd_kernel), which reads q, k, v, o and do from the packed
//     (B, N, 3C) / (B, N, C) layouts and writes dq, dk and dv;
//   - vit_ae_plus_plus_tpu/kernels/pallas_flash.py::_bwd (_mh_bwd_kernel,
//     _fused_bwd_kernel, _dq_kernel and _dkv_kernel), the same gradients on
//     the per-head (B, H, N, D) layout;
//   - vit_ae_plus_plus_tpu/kernels/ring_flash.py::_partial_bwd
//     (_ring_bwd_kernel): one ring step's dq, dk and dv of the local query
//     rows against one K/V block, from the MERGED o and lse of the whole
//     row, with the block's additive key bias (0 valid, -1e30 pad).
// All compute, from the forward's o and lse (csrc/flash_fwd.cu):
//   P = exp(q k^T * scale + bias - lse), dv = P^T do, dP = do v^T,
//   delta = rowsum(do * o), dS = P * (dP - delta),
//   dq = scale * dS k, dk = scale * dS^T q.
// The bias is a template flag (HAS_BIAS), as in the forward. q, o and do
// have seq_len rows, k and v kv_len rows. The lse of a ring step is the
// row's global one, always finite (every query row sees a valid key), so
// a pad key's P = exp2(-1.44e30 - lse2) is exactly 0 and its dk, dv rows
// stay 0.
// As in the forward, every operand is addressed through (batch, token,
// head) strides with a contiguous head_dim axis: the packed wrapper passes
// three strided views of the (B, N, 3C) projection and of one (B, N, 3C)
// gradient, the per-head wrapper transposed views.
//
// What bounds it: 10 * B*H*N^2*d operations (five N x N x d products, two
// of them recomputing the forward's) against some 60 MB of operands at the
// decoder shape: far above the H100's ~295 FLOP/byte ridge, so it is bound
// by tensor-core throughput. The N x N scores never reach device memory.
//
// Design, deterministic and without atomics: three launches on one stream.
//   1. delta pre-pass: one warp per (b, h, row), delta = rowsum(do * o) in
//      f32 into a (B, H, N) scratch.
//   2. dK/dV kernel: one block of 4 warps per (b, h, 64-key tile); each warp
//      owns 16 keys. It loops over every 64-query tile (q, do, lse and delta
//      staged in shared memory) and, 16 queries at a time, computes
//      S^T = K Q^T and dP^T = V dO^T on the tensor cores. That puts P^T and
//      dS^T in accumulator layout, which rounded to bf16 is the A fragment
//      of dV += P^T dO and dK += dS^T Q (the forward reuses its S the same
//      way). dK and dV stay in f32 registers for the whole loop.
//   3. dQ kernel: one block per (b, h, 64-query tile), looping over 64-key
//      tiles: S = Q K^T, dP = dO V^T, dQ += dS K.
// mma.sync m16n8k16 bf16 with f32 accumulation; P and dS are rounded to bf16
// before their products. Ragged tails: rows past their length are
// zero-filled when staged; query rows past seq_len have lse read as +inf
// (so P = 0) and delta as 0, keys past kv_len get P = 0 in the dQ kernel,
// and nothing is stored past seq_len (dq) or kv_len (dk, dv). Shared
// memory is dynamic (4 tiles of 64 x (D+8) bf16: 70 KB at D = 128), so the
// accumulators are the only per-thread arrays (D/2 floats each of dK, dV).
// The dQ kernel keeps its key tile's bias in the 2 x 64 floats that the
// dK/dV kernel uses for lse and delta.
// Not yet done (a later change): cp.async/TMA double buffering, wgmma.
//
// The f32 kernels (compute_dtype float32, off the default bf16 path) use
// scalar FMAs: D/16 neighbouring threads share one key (or query) row, each
// holding 16 of its dims, and reduce their dot products with shuffles.

#include "flash_common.cuh"

struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* do_;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, H, N) f32, from the forward
  float* delta;      // (B, H, N) f32 scratch, written by the pre-pass
  const float* key_bias;  // (kv_len,) f32 additive bias over the keys, or null
  long long q_sb, q_sn, q_sh;  // element strides of (batch, token, head)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  int batch, heads, seq_len, kv_len, head_dim;  // seq_len query rows, kv_len keys
  float scale;
};

namespace {

using namespace flash;

constexpr int kThreads = 128;
constexpr int kBlock = 64;  // rows of a block's own tile, and of each staged tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Offset of (batch b, head h) in a tensor with strides (sb, -, sh).
__device__ __forceinline__ long long bh_offset(long long sb, long long sh, int b, int h) {
  return b * sb + h * sh;
}

// ------------------------------------------------------------ delta pre-pass

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const FlashBwdParams p) {
  const long long rows = (long long)p.batch * p.heads * p.seq_len;
  const long long r = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int n = p.seq_len;
  const int row = static_cast<int>(r % n);
  const int h = static_cast<int>((r / n) % p.heads);
  const int b = static_cast<int>(r / ((long long)n * p.heads));
  const T* og = static_cast<const T*>(p.o) + bh_offset(p.o_sb, p.o_sh, b, h) + row * p.o_sn;
  const T* dg = static_cast<const T*>(p.do_) + bh_offset(p.do_sb, p.do_sh, b, h) + row * p.do_sn;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(og[c]), to_float(dg[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ---------------------------------------------------------------- bf16 path

template <int D>
constexpr int bf16_smem_bytes() {
  return 4 * kBlock * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16)) +
         2 * kBlock * static_cast<int>(sizeof(float));
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_bf16_kernel(const FlashBwdParams p) {
  constexpr int LD = D + 8;  // padded row pitch, in elements
  constexpr int KT = D / 16;  // 16-deep steps over head_dim
  constexpr int NT = D / 8;   // 8-column tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBlock * LD;
  __nv_bfloat16* qs = vs + kBlock * LD;
  __nv_bfloat16* dos = qs + kBlock * LD;
  float* lse_s = reinterpret_cast<float*>(dos + kBlock * LD);  // lse * log2(e); +inf past N
  float* delta_s = lse_s + kBlock;                             // delta; 0 past N

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = p.seq_len;
  const int nk = p.kv_len;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + bh_offset(p.q_sb, p.q_sh, b, h);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + bh_offset(p.k_sb, p.k_sh, b, h);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + bh_offset(p.v_sb, p.v_sh, b, h);
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.do_) + bh_offset(p.do_sb, p.do_sh, b, h);
  const float* lse_g = p.lse + ((long long)b * p.heads + h) * n;
  const float* delta_g = p.delta + ((long long)b * p.heads + h) * n;

  load_tile<D, LD, kBlock, kThreads>(ks, kg, p.k_sn, k0, nk);
  load_tile<D, LD, kBlock, kThreads>(vs, vg, p.v_sn, k0, nk);
  float kb[2] = {0.f, 0.f};  // the bias of this thread's keys (rows g, g + 8), log2 units
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + warp * 16 + g + 8 * r;
      kb[r] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
    }
  }

  float dk[NT][4];
  float dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;
  const __nv_bfloat16* kw = ks + (warp * 16 + g) * LD + 2 * t;  // this warp's 16 keys
  const __nv_bfloat16* vw = vs + (warp * 16 + g) * LD + 2 * t;

  for (int q0 = 0; q0 < n; q0 += kBlock) {
    __syncthreads();  // the previous query tile is consumed
    load_tile<D, LD, kBlock, kThreads>(qs, qg, p.q_sn, q0, n);
    load_tile<D, LD, kBlock, kThreads>(dos, dog, p.do_sn, q0, n);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? lse_g[row] * kLog2e : INFINITY;
      delta_s[threadIdx.x] = row < n ? delta_g[row] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kBlock / 16; ++c) {  // 16 queries at a time
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x two 8-query tiles
      float s[2][4];
      float dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
        const __nv_bfloat16* qb = qs + (c * 16 + jj * 8 + g) * LD + 2 * t;
        const __nv_bfloat16* dob = dos + (c * 16 + jj * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          load_a<LD>(a, kw, kk);
          mma_16816(s[jj], a, ld32(qb + kk * 16), ld32(qb + kk * 16 + 8));
          load_a<LD>(a, vw, kk);
          mma_16816(dp[jj], a, ld32(dob + kk * 16), ld32(dob + kk * 16 + 8));
        }
      }
      // P^T and dS^T in place; dead query columns have lse +inf, so P = 0
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + jj * 8 + 2 * t + (e & 1);
          float x = s[jj][e] * scale2;
          if constexpr (HAS_BIAS) x += kb[e >> 1];
          const float pv = exp2f(x - lse_s[col]);
          s[jj][e] = pv;
          dp[jj][e] = pv * (dp[jj][e] - delta_s[col]);
        }
      }
      uint32_t pa[4];
      uint32_t da[4];
      pa[0] = pack_f32(s[0][0], s[0][1]);
      pa[1] = pack_f32(s[0][2], s[0][3]);
      pa[2] = pack_f32(s[1][0], s[1][1]);
      pa[3] = pack_f32(s[1][2], s[1][3]);
      da[0] = pack_f32(dp[0][0], dp[0][1]);
      da[1] = pack_f32(dp[0][2], dp[0][3]);
      da[2] = pack_f32(dp[1][0], dp[1][1]);
      da[3] = pack_f32(dp[1][2], dp[1][3]);
      // dV += P^T dO and dK += dS^T Q over these 16 queries
      const __nv_bfloat16* dob = dos + (c * 16 + 2 * t) * LD + g;
      const __nv_bfloat16* qb = qs + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* col = dob + j * 8;
        mma_16816(dv[j], pa, pack_bf16(col[0], col[LD]), pack_bf16(col[8 * LD], col[9 * LD]));
        col = qb + j * 8;
        mma_16816(dk[j], da, pack_bf16(col[0], col[LD]), pack_bf16(col[8 * LD], col[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + warp * 16 + g + 8 * r;
    if (key >= nk) continue;  // dead key rows are not stored
    __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + bh_offset(p.dk_sb, p.dk_sh, b, h) +
                         key * p.dk_sn + 2 * t;
    __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + bh_offset(p.dv_sb, p.dv_sh, b, h) +
                         key * p.dv_sn + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dkg + j * 8) =
          pack_f32(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + j * 8) = pack_f32(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const FlashBwdParams p) {
  constexpr int LD = D + 8;
  constexpr int KT = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kBlock * LD;
  __nv_bfloat16* ks = dos + kBlock * LD;
  __nv_bfloat16* vs = ks + kBlock * LD;
  float* bias_s = reinterpret_cast<float*>(vs + kBlock * LD);  // the key tile's bias, log2 units

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = p.seq_len;
  const int nk = p.kv_len;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + bh_offset(p.q_sb, p.q_sh, b, h);
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + bh_offset(p.k_sb, p.k_sh, b, h);
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + bh_offset(p.v_sb, p.v_sh, b, h);
  const __nv_bfloat16* dog = static_cast<const __nv_bfloat16*>(p.do_) + bh_offset(p.do_sb, p.do_sh, b, h);
  const float* lse_g = p.lse + ((long long)b * p.heads + h) * n;
  const float* delta_g = p.delta + ((long long)b * p.heads + h) * n;

  load_tile<D, LD, kBlock, kThreads>(qs, qg, p.q_sn, q0, n);
  load_tile<D, LD, kBlock, kThreads>(dos, dog, p.do_sn, q0, n);
  float lse2[2];  // rows g and g + 8 of this warp: lse * log2(e), +inf past N
  float dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    lse2[r] = row < n ? lse_g[row] * kLog2e : INFINITY;
    dl[r] = row < n ? delta_g[row] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const float scale2 = p.scale * kLog2e;
  const __nv_bfloat16* qw = qs + (warp * 16 + g) * LD + 2 * t;  // this warp's 16 queries
  const __nv_bfloat16* dow = dos + (warp * 16 + g) * LD + 2 * t;

  for (int k0 = 0; k0 < nk; k0 += kBlock) {
    __syncthreads();  // the previous key tile (or the Q staging) is consumed
    load_tile<D, LD, kBlock, kThreads>(ks, kg, p.k_sn, k0, nk);
    load_tile<D, LD, kBlock, kThreads>(vs, vg, p.v_sn, k0, nk);
    if constexpr (HAS_BIAS) {
      if (threadIdx.x < kBlock) {
        const int key = k0 + threadIdx.x;
        bias_s[threadIdx.x] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < kBlock / 16; ++c) {  // 16 keys at a time
      float s[2][4];
      float dp[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
        const __nv_bfloat16* kb = ks + (c * 16 + jj * 8 + g) * LD + 2 * t;
        const __nv_bfloat16* vb = vs + (c * 16 + jj * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          load_a<LD>(a, qw, kk);
          mma_16816(s[jj], a, ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
          load_a<LD>(a, dow, kk);
          mma_16816(dp[jj], a, ld32(vb + kk * 16), ld32(vb + kk * 16 + 8));
        }
      }
      // dS, with keys past kv_len masked to P = 0
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c * 16 + jj * 8 + 2 * t + (e & 1);
          float x = s[jj][e] * scale2;
          if constexpr (HAS_BIAS) x += bias_s[c * 16 + jj * 8 + 2 * t + (e & 1)];
          const float pv = key < nk ? exp2f(x - lse2[e >> 1]) : 0.f;
          dp[jj][e] = pv * (dp[jj][e] - dl[e >> 1]);
        }
      }
      uint32_t da[4];
      da[0] = pack_f32(dp[0][0], dp[0][1]);
      da[1] = pack_f32(dp[0][2], dp[0][3]);
      da[2] = pack_f32(dp[1][0], dp[1][1]);
      da[3] = pack_f32(dp[1][2], dp[1][3]);
      // dQ += dS K over these 16 keys
      const __nv_bfloat16* kb = ks + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* col = kb + j * 8;
        mma_16816(dq[j], da, pack_bf16(col[0], col[LD]), pack_bf16(col[8 * LD], col[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + bh_offset(p.dq_sb, p.dq_sh, b, h) +
                         row * p.dq_sn + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(dqg + j * 8) =
          pack_f32(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
    }
  }
}

// ----------------------------------------------------------------- f32 path

constexpr int kF32Tile = 32;  // rows per shared-memory tile

// D/16 neighbouring threads share one row; thread `sub` of the group holds
// dims sub, sub + G, ..., sub + 15G (neighbouring threads read neighbouring
// words of shared memory).
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32_kernel(const FlashBwdParams p) {
  constexpr int G = D / 16;
  constexpr int kRows = kThreads / G;
  __shared__ float qs[kF32Tile][D];
  __shared__ float dos[kF32Tile][D];
  __shared__ float lse_s[kF32Tile];
  __shared__ float delta_s[kF32Tile];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % G;
  const int key = blockIdx.x * kRows + threadIdx.x / G;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const bool live = key < nk;

  const float* qg = static_cast<const float*>(p.q) + bh_offset(p.q_sb, p.q_sh, b, h);
  const float* kg = static_cast<const float*>(p.k) + bh_offset(p.k_sb, p.k_sh, b, h);
  const float* vg = static_cast<const float*>(p.v) + bh_offset(p.v_sb, p.v_sh, b, h);
  const float* dog = static_cast<const float*>(p.do_) + bh_offset(p.do_sb, p.do_sh, b, h);
  const float* lse_g = p.lse + ((long long)b * p.heads + h) * n;
  const float* delta_g = p.delta + ((long long)b * p.heads + h) * n;

  float kr[16], vr[16], dk[16], dv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    kr[i] = live ? kg[key * p.k_sn + sub + G * i] : 0.f;
    vr[i] = live ? vg[key * p.v_sn + sub + G * i] : 0.f;
    dk[i] = dv[i] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;
  float kb = 0.f;  // this key's bias, log2 units
  if constexpr (HAS_BIAS) kb = live ? p.key_bias[key] * kLog2e : 0.f;

  for (int q0 = 0; q0 < n; q0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool ok = q0 + r < n;
      qs[r][c] = ok ? qg[(q0 + r) * p.q_sn + c] : 0.f;
      dos[r][c] = ok ? dog[(q0 + r) * p.do_sn + c] : 0.f;
    }
    if (threadIdx.x < kF32Tile) {
      const int row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < n ? lse_g[row] * kLog2e : INFINITY;
      delta_s[threadIdx.x] = row < n ? delta_g[row] : 0.f;
    }
    __syncthreads();
    const int rows = min(kF32Tile, n - q0);
    for (int j = 0; j < rows; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s = fmaf(kr[i], qs[j][sub + G * i], s);
        dp = fmaf(vr[i], dos[j][sub + G * i], dp);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      float x = s * scale2;
      if constexpr (HAS_BIAS) x += kb;
      const float pv = exp2f(x - lse_s[j]);
      const float ds = pv * (dp - delta_s[j]);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dv[i] = fmaf(pv, dos[j][sub + G * i], dv[i]);
        dk[i] = fmaf(ds, qs[j][sub + G * i], dk[i]);
      }
    }
  }
  if (!live) return;
  float* dkg = static_cast<float*>(p.dk) + bh_offset(p.dk_sb, p.dk_sh, b, h) + key * p.dk_sn;
  float* dvg = static_cast<float*>(p.dv) + bh_offset(p.dv_sb, p.dv_sh, b, h) + key * p.dv_sn;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dkg[sub + G * i] = dk[i] * p.scale;
    dvg[sub + G * i] = dv[i];
  }
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const FlashBwdParams p) {
  constexpr int G = D / 16;
  constexpr int kRows = kThreads / G;
  __shared__ float ks[kF32Tile][D];
  __shared__ float vs[kF32Tile][D];
  __shared__ float bias_s[HAS_BIAS ? kF32Tile : 1];  // log2 units

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % G;
  const int row = blockIdx.x * kRows + threadIdx.x / G;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const bool live = row < n;

  const float* qg = static_cast<const float*>(p.q) + bh_offset(p.q_sb, p.q_sh, b, h);
  const float* kg = static_cast<const float*>(p.k) + bh_offset(p.k_sb, p.k_sh, b, h);
  const float* vg = static_cast<const float*>(p.v) + bh_offset(p.v_sb, p.v_sh, b, h);
  const float* dog = static_cast<const float*>(p.do_) + bh_offset(p.do_sb, p.do_sh, b, h);
  const long long bh = ((long long)b * p.heads + h) * n;
  const float lse2 = live ? p.lse[bh + row] * kLog2e : INFINITY;
  const float dl = live ? p.delta[bh + row] : 0.f;

  float qr[16], dor[16], dq[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    qr[i] = live ? qg[row * p.q_sn + sub + G * i] : 0.f;
    dor[i] = live ? dog[row * p.do_sn + sub + G * i] : 0.f;
    dq[i] = 0.f;
  }
  const float scale2 = p.scale * kLog2e;

  for (int k0 = 0; k0 < nk; k0 += kF32Tile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Tile * D; i += kThreads) {
      const int r = i / D;
      const int c = i % D;
      const bool ok = k0 + r < nk;
      ks[r][c] = ok ? kg[(k0 + r) * p.k_sn + c] : 0.f;
      vs[r][c] = ok ? vg[(k0 + r) * p.v_sn + c] : 0.f;
    }
    if constexpr (HAS_BIAS) {
      if (threadIdx.x < kF32Tile) {
        const int key = k0 + threadIdx.x;
        bias_s[threadIdx.x] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
      }
    }
    __syncthreads();
    const int keys = min(kF32Tile, nk - k0);
    for (int j = 0; j < keys; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        s = fmaf(qr[i], ks[j][sub + G * i], s);
        dp = fmaf(dor[i], vs[j][sub + G * i], dp);
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        dp += __shfl_xor_sync(0xffffffffu, dp, off);
      }
      float x = s * scale2;
      if constexpr (HAS_BIAS) x += bias_s[j];
      const float ds = exp2f(x - lse2) * (dp - dl);
#pragma unroll
      for (int i = 0; i < 16; ++i) dq[i] = fmaf(ds, ks[j][sub + G * i], dq[i]);
    }
  }
  if (!live) return;
  float* dqg = static_cast<float*>(p.dq) + bh_offset(p.dq_sb, p.dq_sh, b, h) + row * p.dq_sn;
#pragma unroll
  for (int i = 0; i < 16; ++i) dqg[sub + G * i] = dq[i] * p.scale;
}

template <int D, bool HAS_BIAS>
cudaError_t launch(const FlashBwdParams& p, int is_bf16, cudaStream_t stream) {
  const long long rows = (long long)p.batch * p.heads * p.seq_len;
  const dim3 delta_grid(static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)));
  if (is_bf16) {
    flash_bwd_delta_kernel<__nv_bfloat16, D><<<delta_grid, kThreads, 0, stream>>>(p);
  } else {
    flash_bwd_delta_kernel<float, D><<<delta_grid, kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (is_bf16) {
    constexpr int smem = bf16_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D, HAS_BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D, HAS_BIAS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 key_grid((p.kv_len + kBlock - 1) / kBlock, p.heads, p.batch);
    const dim3 query_grid((p.seq_len + kBlock - 1) / kBlock, p.heads, p.batch);
    flash_bwd_dkdv_bf16_kernel<D, HAS_BIAS><<<key_grid, kThreads, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<D, HAS_BIAS><<<query_grid, kThreads, smem, stream>>>(p);
  } else {
    constexpr int kRows = kThreads / (D / 16);
    const dim3 key_grid((p.kv_len + kRows - 1) / kRows, p.heads, p.batch);
    const dim3 query_grid((p.seq_len + kRows - 1) / kRows, p.heads, p.batch);
    flash_bwd_dkdv_f32_kernel<D, HAS_BIAS><<<key_grid, kThreads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<D, HAS_BIAS><<<query_grid, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const FlashBwdParams& p, int is_bf16, cudaStream_t stream) {
  return p.key_bias != nullptr ? launch<D, true>(p, is_bf16, stream)
                               : launch<D, false>(p, is_bf16, stream);
}

}  // namespace

extern "C" {

// Launches on `device`'s `stream` and returns the CUDA error (0 on success).
int flash_bwd(const FlashBwdParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->head_dim) {
    case 32: return static_cast<int>(launch<32>(*p, is_bf16, s));
    case 64: return static_cast<int>(launch<64>(*p, is_bf16, s));
    case 128: return static_cast<int>(launch<128>(*p, is_bf16, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
