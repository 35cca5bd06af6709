// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (vit_ae_plus_plus_torch/kernels/_build.py).
//
// Replaces two TPU kernels of the JAX package:
//   - vit_ae_plus_plus_tpu/kernels/packed_flash.py::_packed_fwd
//     (_pk_fwd_kernel), which reads q, k and v straight from the fused
//     projection's (B, N, 3C) output;
//   - vit_ae_plus_plus_tpu/kernels/pallas_flash.py::_fwd (_mh_fwd_kernel and
//     _fwd_kernel), the same attention on the per-head (B, H, N, D) layout.
// Both compute o = softmax(q k^T * scale) v, non-causal, with the ragged key
// tail masked, and optionally lse = log(sum(exp(q k^T * scale))) in f32.
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
// The f32 kernel (compute_dtype float32, off the default bf16 path) uses
// scalar FMAs with one thread per query row, so f32 inputs keep f32 products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

struct FlashFwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, N) f32, or null
  long long q_sb, q_sn, q_sh;  // element strides of (batch, token, head)
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int batch, heads, seq_len, head_dim;
  float scale;
};

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16 path

constexpr int kBlockQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

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

// Rows [row0, row0 + 64) of one head into shared memory (row pitch LD);
// rows at or past n are zero-filled.
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n) {
  constexpr int kVec = 8;  // bf16 per 16-byte load
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kBlockK * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const FlashFwdParams p) {
  constexpr int LD = D + 8;  // padded row pitch, in elements
  constexpr int KT = D / 16;  // k-steps of Q K^T
  constexpr int NT = D / 8;   // 8-column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBlockK * LD];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int n = p.seq_len;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;

  // Stage the Q tile through ks, then keep this warp's 16 rows in registers
  // as m16n8k16 A fragments.
  load_tile<D, LD>(ks, qg, p.q_sn, q0, n);
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

  for (int k0 = 0; k0 < n; k0 += kBlockK) {
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    load_tile<D, LD>(ks, kg, p.k_sn, k0, n);
    load_tile<D, LD>(vs, vg, p.v_sn, k0, n);
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

    // scale into log2 units, mask the ragged key tail, new running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float x = key < n ? s[j][e] * scale2 : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    // every tile holds key k0 < n, so mx is finite from the first tile on
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

constexpr int kF32Rows = 64;  // query rows per block, one per thread
constexpr int kF32Keys = 32;  // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kF32Rows)
flash_fwd_f32_kernel(const FlashFwdParams p) {
  __shared__ float ks[kF32Keys][D];
  __shared__ float vs[kF32Keys][D];

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kF32Rows + threadIdx.x;
  const int n = p.seq_len;
  const bool live = row < n;

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float q[D];
  float acc[D];
  const float scale2 = p.scale * kLog2e;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = live ? qg[(long long)row * p.q_sn + d] * scale2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n; k0 += kF32Keys) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32Keys * D; i += kF32Rows) {
      const int r = i / D;
      const int c = i % D;
      const bool ok = k0 + r < n;
      ks[r][c] = ok ? kg[(long long)(k0 + r) * p.k_sn + c] : 0.f;
      vs[r][c] = ok ? vg[(long long)(k0 + r) * p.v_sn + c] : 0.f;
    }
    __syncthreads();

    float s[kF32Keys];
    float mx = m;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) x = fmaf(q[d], ks[j][d], x);
      s[j] = k0 + j < n ? x : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = exp2f(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      const float pj = exp2f(s[j] - m);
      l += pj;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, vs[j][d], acc[d]);
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + (long long)row * p.o_sn + h * p.o_sh;
#pragma unroll
  for (int d = 0; d < D; ++d) og[d] = acc[d] * inv;
  if (p.lse != nullptr) {
    p.lse[((long long)b * p.heads + h) * n + row] = (m + log2f(l)) * kLn2;
  }
}

template <int D>
cudaError_t launch(const FlashFwdParams& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.heads, p.batch);
    flash_fwd_bf16_kernel<D><<<grid, kThreads, 0, stream>>>(p);
  } else {
    const dim3 grid((p.seq_len + kF32Rows - 1) / kF32Rows, p.heads, p.batch);
    flash_fwd_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return cudaGetLastError();
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
