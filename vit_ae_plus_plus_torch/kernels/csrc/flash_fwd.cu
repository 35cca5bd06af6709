// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (vit_ae_plus_plus_torch/kernels/_build.py).
//
// Replaces three TPU kernels of the JAX package:
//   - vit_ae_plus_plus_tpu/kernels/packed_flash.py::_packed_fwd
//     (_pk_fwd_kernel), which reads q, k and v straight from the fused
//     projection's (B, N, 3C) output;
//   - vit_ae_plus_plus_tpu/kernels/pallas_flash.py::_fwd (_mh_fwd_kernel and
//     _fwd_kernel), the same attention on the per-head (B, H, N, D) layout;
//   - vit_ae_plus_plus_tpu/kernels/ring_flash.py::_partial_fwd
//     (_ring_fwd_kernel): the local query rows against one K/V block of the
//     ring, with an additive f32 bias over the block's keys (0 for a valid
//     key, -1e30 for a pad key).
// All compute o = softmax(q k^T * scale + bias) v, non-causal, with the
// ragged key tail masked, and optionally lse = log(sum(exp(q k^T * scale +
// bias))) in f32. The bias is a template flag (HAS_BIAS): the bias-free
// instances are the packed and per-head paths' kernels. q has seq_len rows,
// k and v kv_len rows (the sequence-sharded path runs a shard of the query
// rows against every key).
//
// Addressing: q, k, v and o are read and written through (batch, token,
// head) strides given as arguments, with the head_dim axis contiguous. The
// packed view (strides N*3C, 3C, d) and the per-head layout (strides N*H*D
// or H*N*D, ...) therefore run the same code, with no transpose and no copy.
//
// What bounds it: at the serving shape (B=8, H=12, N=1729, d=64) attention
// is 73.5 GFLOP against 28 MB of operands, about 2,600 FLOP per byte, far
// above the H100's ~295 FLOP/byte ridge: it is bound by tensor-core
// throughput, not by memory. The design keeps the N x N scores out of device
// memory (online softmax over 64-key tiles in registers) and runs both
// products on the tensor cores with mma.sync m16n8k16 bf16 -> f32.
//
// Design of the bf16 kernel: one block of 4 warps per (batch, head, 64-row
// query tile); each warp owns 16 query rows, whose Q fragments stay in
// registers. K and V tiles of 64 keys are staged in shared memory with 16-byte
// loads, in rows padded by 8 elements so that fragment reads hit distinct
// banks. Softmax statistics are f32 in the log2 domain; P is rounded to bf16
// for the P V product, as every flash-attention kernel on tensor cores does.
// Not yet done (a later change): cp.async/TMA double buffering, wgmma, and
// warp specialisation.
//
// The f32 kernel (compute_dtype float32, TrainConfig's default) keeps
// f32-accurate products on the tensor cores with 3xTF32 (flash_common.cuh):
// each operand split into a TF32 high and low part, hi*hi + hi*lo + lo*hi
// summed in f32 by mma.sync m16n8k8, lo*lo dropped (about 2^-22 relative per
// product, inside kernel_tolerance's 1e-5 where plain TF32's 2^-11 is not).
// Bound: 3 x 4*B*H*N*Nk*d TF32 operations, so the card's 495 TFLOP/s of
// TF32 give 165 of f32-accurate work. Same tiling as the bf16 kernel (4
// warps x 16 query rows, 64-key tiles, online softmax in the log2 domain),
// with K and V tiles in f32 double-buffered through cp.async, rows padded
// by 4 floats for conflict-free fragment reads (70 KB at d = 64, so dynamic
// shared memory). Operands need 16-byte aligned rows (the wrapper checks).

#include "flash_common.cuh"

struct FlashFwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, seq_len) f32, or null
  const float* key_bias;  // (kv_len,) f32 additive bias over the keys, or null
  long long q_sb, q_sn, q_sh;  // element strides of (batch, token, head)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int batch, heads, seq_len, kv_len, head_dim;  // seq_len query rows, kv_len keys
  float scale;
};

namespace {

using namespace flash;

// ---------------------------------------------------------------- bf16 path

constexpr int kBlockQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const FlashFwdParams p) {
  constexpr int LD = D + 8;  // padded row pitch, in elements
  constexpr int KT = D / 16;  // k-steps of Q K^T
  constexpr int NT = D / 8;   // 8-column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * LD];
  __shared__ float bias_s[HAS_BIAS ? kBlockK : 1];  // the tile's bias, log2 units

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int n = p.seq_len;
  const int nk = p.kv_len;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // Stage the Q tile through ks, then keep this warp's 16 rows in registers
  // as m16n8k16 A fragments.
  load_tile<D, LD, kBlockK, kThreads>(ks, qg, p.q_sn, q0, n);
  __syncthreads();
  uint32_t qa[KT][4];
  {
    const __nv_bfloat16* base = ks + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qa[kk][0] = ld32(base + kk * 16);
      qa[kk][1] = ld32(base + kk * 16 + 8 * LD);
      qa[kk][2] = ld32(base + kk * 16 + 8);
      qa[kk][3] = ld32(base + kk * 16 + 8 * LD + 8);
    }
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  // running max (log2 units) and partial row sums of rows g and g + 8
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    load_tile<D, LD, kBlockK, kThreads>(ks, kg, p.k_sn, k0, nk);
    load_tile<D, LD, kBlockK, kThreads>(vs, vg, p.v_sn, k0, nk);
    if constexpr (HAS_BIAS) {
      if (threadIdx.x < kBlockK) {
        const int key = k0 + threadIdx.x;
        bias_s[threadIdx.x] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
      }
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: eight 8-key tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        mma_16816(s[j], qa[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
      }
    }

    // scale into log2 units, add the bias, mask the ragged key tail, new
    // running max. A pad key's bias (-1e30 * log2(e)) is finite: a tile of
    // pad keys alone gives a finite max and p = 1 for each, so an all-pad
    // block ends with l = kv_len and lse ~ -1e30, which the merge weights 0.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float x = key < nk ? s[j][e] * scale2 : -INFINITY;
        if constexpr (HAS_BIAS) x += bias_s[j * 8 + 2 * t + (e & 1)];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds key k0 < kv_len, so mx is finite from the first tile on
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2c and 2c+1 are exactly the
    // A fragment of a 16-key step once rounded to bf16
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack_f32(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack_f32(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack_f32(s[2 * c + 1][2], s[2 * c + 1][3]);
      const __nv_bfloat16* vb = vs + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* col = vb + j * 8;
        const uint32_t b0 = pack_bf16(col[0], col[LD]);
        const uint32_t b1 = pack_bf16(col[8 * LD], col[9 * LD]);
        mma_16816(acc[j], pa, b0, b1);
      }
    }
  }

  // full row sums over the four threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;  // dead query rows are not stored
    const float inv = 1.f / l[r];
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                        (long long)row * p.o_sn + h * p.o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<uint32_t*>(og + j * 8) =
          pack_f32(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)b * p.heads + h) * n + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

// ----------------------------------------------------------------- f32 path

// K and V tiles of kBlockK keys in f32, two stages, rows padded by 4 floats
// so that the m16n8k8 fragment reads hit 32 distinct banks; then the two
// stages' key bias (log2 units).
template <int D>
constexpr int f32_smem_bytes() {
  return (2 * 2 * kBlockK * (D + 4) + 2 * kBlockK) * static_cast<int>(sizeof(float));
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const FlashFwdParams p) {
  constexpr int LD = D + 4;   // padded row pitch, in floats
  constexpr int KT = D / 8;   // k-steps of Q K^T
  constexpr int NT = D / 8;   // 8-column tiles of O
  constexpr int kStage = 2 * kBlockK * LD;  // K then V of one stage, in floats
  extern __shared__ __align__(16) float f32_smem[];
  float* bias_s = f32_smem + 2 * kStage;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n = p.seq_len;
  const int nk = p.kv_len;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  // K and V rows k0..k0+63 into one stage (rows past kv_len zero-filled),
  // 16 bytes a copy, and the stage's bias
  auto load_kv = [&](int stage, int k0) {
    constexpr int kPerRow = D / 4;
    float* ks = f32_smem + stage * kStage;
    float* vs = ks + kBlockK * LD;
    for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
      const int r = i / kPerRow;
      const int c = (i % kPerRow) * 4;
      const bool ok = k0 + r < nk;
      const long long row = ok ? k0 + r : 0;
      cp_async16(ks + r * LD + c, kg + row * p.k_sn + c, ok);
      cp_async16(vs + r * LD + c, vg + row * p.v_sn + c, ok);
    }
    if constexpr (HAS_BIAS) {
      if (threadIdx.x < kBlockK) {
        const int key = k0 + threadIdx.x;
        bias_s[stage * kBlockK + threadIdx.x] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
      }
    }
  };

  // Stage the Q tile through stage 0, then keep this warp's 16 rows in
  // registers as m16n8k8 A fragments in f32, split into hi and lo at each use
  // (rows past seq_len are zeros and are not stored).
  for (int i = threadIdx.x; i < kBlockQ * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < n) val = *reinterpret_cast<const float4*>(qg + (long long)(q0 + r) * p.q_sn + c);
    *reinterpret_cast<float4*>(f32_smem + r * LD + c) = val;
  }
  __syncthreads();
  float qf[KT][4];
  {
    const float* base = f32_smem + (warp * 16 + g) * LD + t;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = base[kk * 8];
      qf[kk][1] = base[kk * 8 + 8 * LD];
      qf[kk][2] = base[kk * 8 + 4];
      qf[kk][3] = base[kk * 8 + 8 * LD + 4];
    }
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  const float scale2 = p.scale * kLog2e;

  const int ktiles = (nk + kBlockK - 1) / kBlockK;
  load_kv(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ktiles; ++tile) {
    if (tile + 1 < ktiles) load_kv((tile + 1) & 1, (tile + 1) * kBlockK);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's stage has landed (the next may be in flight)
    __syncthreads();
    const float* ks = f32_smem + (tile & 1) * kStage;
    const float* vs = ks + kBlockK * LD;
    const float* bs = bias_s + (tile & 1) * kBlockK;
    const int k0 = tile * kBlockK;

    // S = Q K^T for 16 rows x 64 keys, 3xTF32
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_a(qf[kk], a_hi, a_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kb = ks + (j * 8 + g) * LD + kk * 8 + t;
        mma_1688_3xtf32(s[j], a_hi, a_lo, split_tf32(kb[0]), split_tf32(kb[4]));
      }
    }

    // scale into log2 units, add the bias, mask the ragged key tail, new
    // running max: as in the bf16 kernel
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        float x = key < nk ? s[j][e] * scale2 : -INFINITY;
        if constexpr (HAS_BIAS) x += bs[j * 8 + 2 * t + (e & 1)];
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    }

    // O = O * alpha + P V, the tile's P V in a fresh accumulator, 3xTF32.
    // S's accumulator of key tile j holds keys 2t and 2t+1, where the
    // m16n8k8 A fragment wants k = t and t + 4: P is taken
    // as it lies, with its keys permuted within the tile, and V's B fragment
    // reads the same keys (rows 2t and 2t+1); the sum over keys is
    // order-free. The tensor cores' f32 sums truncate; a tile's 24 of them
    // stay a few 2^-24 off, where a row's thousands would drift by 1e-5:
    // the tiles are summed on the FMA pipes, rounded to nearest.
    float pv[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c) pv[c][0] = pv[c][1] = pv[c][2] = pv[c][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pa[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t p_hi[4], p_lo[4];
      split_a(pa, p_hi, p_lo);
      const float* vb = vs + (j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        mma_1688_3xtf32(pv[c], p_hi, p_lo, split_tf32(vb[c * 8]), split_tf32(vb[c * 8 + LD]));
      }
    }
#pragma unroll
    for (int c = 0; c < NT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(acc[c][e], alpha[e >> 1], pv[c][e]);
    }
    __syncthreads();  // the stage is consumed before the next-but-one load overwrites it
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l[r];
    float* og = static_cast<float*>(p.o) + b * p.o_sb + (long long)row * p.o_sn + h * p.o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<float2*>(og + j * 8) = make_float2(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)b * p.heads + h) * n + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, bool HAS_BIAS>
cudaError_t launch(const FlashFwdParams& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.heads, p.batch);
    flash_fwd_bf16_kernel<D, HAS_BIAS><<<grid, kThreads, 0, stream>>>(p);
  } else {
    constexpr int smem = f32_smem_bytes<D>();
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, HAS_BIAS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.heads, p.batch);
    flash_fwd_f32_kernel<D, HAS_BIAS><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const FlashFwdParams& p, int is_bf16, cudaStream_t stream) {
  return p.key_bias != nullptr ? launch<D, true>(p, is_bf16, stream)
                               : launch<D, false>(p, is_bf16, stream);
}

}  // namespace

extern "C" {

// Launches on `device`'s `stream` and returns the CUDA error (0 on success).
int flash_fwd(const FlashFwdParams* p, int is_bf16, int device, void* stream) {
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

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
