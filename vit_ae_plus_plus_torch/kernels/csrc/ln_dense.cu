// LayerNorm fused into the next Dense layer, forward and backward, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (vit_ae_plus_plus_torch/kernels/_build.py).
//
// Replaces the two TPU kernels of the JAX package's kernels/fused_ln_dense.py:
//   - _fwd_cp (_lnd_fwd_kernel): y = LN(x).astype(cdt) @ W + b, the product
//     accumulated in f32, rounded to the compute dtype cdt, then the bias
//     added in cdt (fused_ln_dense.py:76-77); mu and rstd emitted in f32;
//   - _bwd_cp (_lnd_bwd_kernel): dln = dY @ W^T in f32, then
//     dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = dln * gamma;
//     dx (in x's dtype) and dln (f32) are emitted. dW, db, dgamma and dbeta
//     are computed outside the kernel, as in JAX (kernels/fused_ln_dense.py
//     of the port).
// W is in PyTorch's (F, C) layout: y = ln W^T. Every block's dims: R rows
// (tokens), C features in (the LayerNorm's width), F features out.
//
// What bounds it: at the training encoder's qkv shape (R = 6,928, C = 768,
// F = 2,304) the product is 24.5 GFLOP against 15 MB of operands, some
// 1,600 operations per byte, far above the H100's ~295 FLOP/byte ridge: it
// is bound by tensor-core throughput. The point of the TPU kernel is that
// the normalised activations never reach device memory, and so here: the
// forward block normalises its rows into shared memory and uses them as the
// resident A operand of the product.
//
// Forward, bf16: one block of 8 warps per (128 output columns, 64 rows),
// the column tile the fast grid index so that the blocks that share rows run
// together. The block computes its rows' statistics with warp reductions
// (csrc/ln_rows.cuh) and writes the normalised rows, rounded to bf16, into
// shared memory (64 x (C + 8) bf16: 99 KB at C = 768, so dynamic shared
// memory above 48 KB). Recomputing the statistics in each of the F / 128
// column tiles is cheap next to the product. W tiles of 128 x 64 stream in
// through cp.async, two stages, the first issued before the LayerNorm so
// that it lands meanwhile. Each warp owns a 32 x 32 output tile of
// mma.sync m16n8k16 bf16 -> f32. Rows past R are zero in shared memory and
// not stored; columns past F read zero W rows and are not stored.
//
// Backward, bf16, two launches on one stream: a product kernel for dln
// (64 x 128 tiles of (R, C), F in steps of 32, dY and W tiles through
// cp.async, two stages; W (F, C) is the B operand un-transposed, so its
// fragments come from shared memory through ldmatrix.trans), then the row
// pass that the LayerNorm backward also runs (csrc/ln_rows.cuh), reading
// dln in f32.
// Not yet done (a later change): wgmma with TMA, a persistent schedule, and
// fusing the row pass into the product.
//
// The f32 kernels (compute_dtype float32, off the default bf16 path) are
// scalar FMA bodies with the same tiling idea and f32 products.

#include "ln_rows.cuh"

struct LndParams {
  const void* x;       // (R, C) in cdt
  const float* gamma;  // (C,)
  const float* beta;   // (C,)
  const void* w;       // (F, C) in cdt
  const void* b;       // (F,) in cdt
  void* y;             // (R, F) in cdt, forward
  float* mu;           // (R,): written by the forward, read by the backward
  float* rstd;         // (R,)
  const void* dy;      // (R, F) in cdt, backward
  float* dln;          // (R, C) f32, backward
  void* dx;            // (R, C) in cdt, backward
  long long rows;
  int cols;
  int features;
  float eps;
};

namespace {

using namespace flash;
using namespace lnrows;

// ------------------------------------------------------------ async copies

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices, transposed: lanes 8m..8m+7 give the row
// addresses of matrix m, and register m receives the fragment of matrix m.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The TPU kernel's epilogue order: the f32 sum rounded to bf16, then the
// bf16 bias added and the result rounded again (fused_ln_dense.py:76-77).
__device__ __forceinline__ float round_then_bias(float acc, float bias) {
  return __bfloat162float(__float2bfloat16(acc)) + bias;
}

// ------------------------------------------------------------ bf16 forward

constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int kBM = 64;        // rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // depth of one W stage
constexpr int kLDW = kBK + 8;  // padded pitch of a W stage row, in elements

template <int C>
constexpr int fwd_smem_bytes() {
  return (kBM * (C + 8) + 2 * kBN * kLDW) * static_cast<int>(sizeof(__nv_bfloat16));
}

template <int C>
__global__ void __launch_bounds__(kThreads) vitae_lnd_fwd_bf16_kernel(const LndParams p) {
  using bf16 = __nv_bfloat16;
  constexpr int LDA = C + 8;
  constexpr int kSteps = C / kBK;
  constexpr int V = RowShape<bf16, C>::V;
  constexpr int J = RowShape<bf16, C>::J;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // the block's normalised rows
  bf16* ws = as + kBM * LDA;                 // two W stages of kBN x kLDW

  const int n0 = blockIdx.x * kBN;
  const long long r0 = (long long)blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int f_out = p.features;
  const long long rows = p.rows;
  const bf16* w = static_cast<const bf16*>(p.w);

  // W rows n0..n0+127 (output features), columns k0..k0+63: 1,024 vectors
  auto load_w = [&](int stage, int k0) {
    bf16* dst = ws + stage * kBN * kLDW;
#pragma unroll
    for (int u = 0; u < kBN * kBK / 8 / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / (kBK / 8);
      const int c8 = (i % (kBK / 8)) * 8;
      const bool ok = n0 + r < f_out;
      cp_async16(dst + r * kLDW + c8, w + (long long)(ok ? n0 + r : 0) * C + k0 + c8, ok);
    }
  };
  load_w(0, 0);
  cp_async_commit();

  // LayerNorm of the block's rows into `as`, rounded to bf16: warp w takes
  // rows w, w + 8, ...
  for (int i = warp; i < kBM; i += kThreads / 32) {
    const long long row = r0 + i;
    bf16* dst = as + i * LDA;
    float v[J][V];
    if (row < rows) {
      const float2 st = row_stats<bf16, C>(static_cast<const bf16*>(p.x) + row * C, v, lane, p.eps);
      normalize(v, st, p.gamma, p.beta, lane);
      if (blockIdx.x == 0 && lane == 0) {
        p.mu[row] = st.x;
        p.rstd[row] = st.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) store_vec<V>(dst + col_of<V>(j, lane), v[j]);
  }

  const int wm = warp >> 2;  // rows wm*32 .. wm*32+31 of the tile
  const int wn = warp & 3;   // columns wn*32 .. wn*32+31
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
  }
  for (int step = 0; step < kSteps; ++step) {
    if (step + 1 < kSteps) load_w((step + 1) & 1, (step + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed (the next may be in flight)
    __syncthreads();     // ... for every thread; at step 0 also the normalised rows
    const bf16* wst = ws + (step & 1) * kBN * kLDW;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        load_a<LDA>(a[mi], as + (wm * 32 + mi * 16 + g) * LDA + step * kBK + 2 * t, kk);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const bf16* bb = wst + (wn * 32 + nj * 8 + g) * kLDW + kk * 16 + 2 * t;
        const uint32_t b0 = ld32(bb);
        const uint32_t b1 = ld32(bb + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][nj], a[mi], b0, b1);
      }
    }
    __syncthreads();  // the stage is consumed before the next-but-one load overwrites it
  }

  const bf16* bias = static_cast<const bf16*>(p.b);
  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int col = n0 + wn * 32 + nj * 8 + 2 * t;
    if (col >= f_out) continue;  // F is even: col + 1 < F too
    const float b0 = __bfloat162float(bias[col]);
    const float b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = r0 + wm * 32 + mi * 16 + g + 8 * r;
        if (row >= rows) continue;
        *reinterpret_cast<uint32_t*>(y + row * f_out + col) =
            pack_f32(round_then_bias(acc[mi][nj][2 * r], b0), round_then_bias(acc[mi][nj][2 * r + 1], b1));
      }
    }
  }
}

// ------------------------------------------------- bf16 backward: dln = dY W

constexpr int kBKd = 32;          // depth (features out) of one stage
constexpr int kLDAd = kBKd + 8;   // pitch of a dY stage row
constexpr int kLDBd = kBN + 8;    // pitch of a W stage row

__global__ void __launch_bounds__(kThreads) vitae_lnd_dln_bf16_kernel(const LndParams p) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 as[2][kBM * kLDAd];   // dY: 64 rows x 32 features out
  __shared__ __align__(16) bf16 bs[2][kBKd * kLDBd];  // W: 32 features out x 128 features in

  const int c0 = blockIdx.x * kBN;
  const long long r0 = (long long)blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cols = p.cols;
  const int f_out = p.features;
  const long long rows = p.rows;
  const bf16* dy = static_cast<const bf16*>(p.dy);
  const bf16* w = static_cast<const bf16*>(p.w);

  auto load = [&](int stage, int f0) {
    {  // dY rows r0..r0+63, features f0..f0+31: 256 vectors, one a thread
      const int r = threadIdx.x / (kBKd / 8);
      const int c8 = (threadIdx.x % (kBKd / 8)) * 8;
      const bool ok = r0 + r < rows;
      cp_async16(&as[stage][r * kLDAd + c8], dy + (ok ? r0 + r : 0) * f_out + f0 + c8, ok);
    }
#pragma unroll
    for (int u = 0; u < kBKd * kBN / 8 / kThreads; ++u) {  // W rows f0..f0+31, columns c0..c0+127
      const int i = threadIdx.x + u * kThreads;
      const int r = i / (kBN / 8);
      const int c8 = (i % (kBN / 8)) * 8;
      cp_async16(&bs[stage][r * kLDBd + c8], w + (long long)(f0 + r) * cols + c0 + c8, true);
    }
  };

  const int wm = warp >> 2;
  const int wn = warp & 3;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;
  }
  const int ktiles = f_out / kBKd;
  load(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load((kt + 1) & 1, (kt + 1) * kBKd);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* at = as[kt & 1];
    const bf16* bt = bs[kt & 1];
#pragma unroll
    for (int kk = 0; kk < kBKd / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) load_a<kLDAd>(a[mi], at + (wm * 32 + mi * 16 + g) * kLDAd + 2 * t, kk);
      // B fragments of four 8-column tiles, two per ldmatrix: matrix m holds
      // features kk*16 + (m & 1)*8 .. +7 of columns (m >> 1)*8 .. +7
      uint32_t b[4][2];
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        const int m = lane >> 3;
        const bf16* src = bt + (kk * 16 + (m & 1) * 8 + (lane & 7)) * kLDBd + wn * 32 + pair * 16 + (m >> 1) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, src);
        b[2 * pair][0] = r[0];
        b[2 * pair][1] = r[1];
        b[2 * pair + 1][0] = r[2];
        b[2 * pair + 1][1] = r[3];
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long row = r0 + wm * 32 + mi * 16 + g + 8 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = c0 + wn * 32 + nj * 8 + 2 * t;
        *reinterpret_cast<float2*>(p.dln + row * cols + col) =
            make_float2(acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
      }
    }
  }
}

// ------------------------------------------------------------------ f32

constexpr int kF32BM = 32;  // rows per block: 4 groups of 8, one group per 64 threads
constexpr int kF32BN = 64;  // columns per block, one per thread of a group
constexpr int kF32BK = 32;  // depth of one shared-memory stage

template <int C>
constexpr int f32_fwd_smem_bytes() {
  return (kF32BM * C + kF32BK * (kF32BN + 1)) * static_cast<int>(sizeof(float));
}

// y = LN(x) W^T + b in f32: the block's normalised rows stay in shared memory.
template <int C>
__global__ void __launch_bounds__(kThreads) vitae_lnd_fwd_f32_kernel(const LndParams p) {
  constexpr int V = RowShape<float, C>::V;
  constexpr int J = RowShape<float, C>::J;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lns = reinterpret_cast<float*>(smem);  // kF32BM x C
  float* ws = lns + kF32BM * C;                 // kF32BK x (kF32BN + 1), W transposed
  const int n0 = blockIdx.x * kF32BN;
  const long long r0 = (long long)blockIdx.y * kF32BM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tx = threadIdx.x % kF32BN;
  const int ty = threadIdx.x / kF32BN;
  const int f_out = p.features;
  const long long rows = p.rows;
  const float* w = static_cast<const float*>(p.w);

  for (int i = warp; i < kF32BM; i += kThreads / 32) {
    const long long row = r0 + i;
    float v[J][V];
    if (row < rows) {
      const float2 st = row_stats<float, C>(static_cast<const float*>(p.x) + row * C, v, lane, p.eps);
      normalize(v, st, p.gamma, p.beta, lane);
      if (blockIdx.x == 0 && lane == 0) {
        p.mu[row] = st.x;
        p.rstd[row] = st.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) store_vec<V>(lns + i * C + col_of<V>(j, lane), v[j]);
  }

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < C; k0 += kF32BK) {
    __syncthreads();  // the LayerNorm rows are written, the previous stage consumed
    for (int i = threadIdx.x; i < kF32BN * kF32BK; i += kThreads) {
      const int n = i / kF32BK;
      const int k = i % kF32BK;
      ws[k * (kF32BN + 1) + n] = n0 + n < f_out ? w[(long long)(n0 + n) * C + k0 + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kF32BK; ++k) {
      const float wv = ws[k * (kF32BN + 1) + tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(lns[(ty * 8 + i) * C + k0 + k], wv, acc[i]);
    }
  }
  const int col = n0 + tx;
  if (col >= f_out) return;
  const float bias = static_cast<const float*>(p.b)[col];
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = r0 + ty * 8 + i;
    if (row < rows) y[row * f_out + col] = acc[i] + bias;
  }
}

// dln = dY W in f32.
__global__ void __launch_bounds__(kThreads) vitae_lnd_dln_f32_kernel(const LndParams p) {
  __shared__ float dys[kF32BM][kF32BK + 1];
  __shared__ float ws[kF32BK][kF32BN];
  const int c0 = blockIdx.x * kF32BN;
  const long long r0 = (long long)blockIdx.y * kF32BM;
  const int tx = threadIdx.x % kF32BN;
  const int ty = threadIdx.x / kF32BN;
  const int cols = p.cols;
  const int f_out = p.features;
  const long long rows = p.rows;
  const float* dy = static_cast<const float*>(p.dy);
  const float* w = static_cast<const float*>(p.w);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int f0 = 0; f0 < f_out; f0 += kF32BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kF32BM * kF32BK; i += kThreads) {
      const int r = i / kF32BK;
      const int k = i % kF32BK;
      dys[r][k] = r0 + r < rows ? dy[(r0 + r) * f_out + f0 + k] : 0.f;
    }
    for (int i = threadIdx.x; i < kF32BK * kF32BN; i += kThreads) {
      const int k = i / kF32BN;
      const int n = i % kF32BN;
      ws[k][n] = w[(long long)(f0 + k) * cols + c0 + n];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kF32BK; ++k) {
      const float wv = ws[k][tx];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(dys[ty * 8 + i][k], wv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = r0 + ty * 8 + i;
    if (row < rows) p.dln[row * cols + c0 + tx] = acc[i];
  }
}

// ---------------------------------------------------------------- launches

template <int C>
cudaError_t launch_fwd_c(const LndParams& p, int is_bf16, cudaStream_t stream) {
  const unsigned row_tiles = static_cast<unsigned>((p.rows + kBM - 1) / kBM);
  if (is_bf16) {
    constexpr int smem = fwd_smem_bytes<C>();
    const cudaError_t err = cudaFuncSetAttribute(vitae_lnd_fwd_bf16_kernel<C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.features + kBN - 1) / kBN, row_tiles);
    vitae_lnd_fwd_bf16_kernel<C><<<grid, kThreads, smem, stream>>>(p);
  } else {
    constexpr int smem = f32_fwd_smem_bytes<C>();
    const cudaError_t err = cudaFuncSetAttribute(vitae_lnd_fwd_f32_kernel<C>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.features + kF32BN - 1) / kF32BN, static_cast<unsigned>((p.rows + kF32BM - 1) / kF32BM));
    vitae_lnd_fwd_f32_kernel<C><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `device`'s `stream` and returns the CUDA error (0 on
// success). The wrapper (kernels/fused_ln_dense.py) checks the shapes:
// C in {256, 512, 768, 1024}, F a multiple of 32.
int ln_dense_fwd(const LndParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->cols) {
    case 256: return static_cast<int>(launch_fwd_c<256>(*p, is_bf16, s));
    case 512: return static_cast<int>(launch_fwd_c<512>(*p, is_bf16, s));
    case 768: return static_cast<int>(launch_fwd_c<768>(*p, is_bf16, s));
    case 1024: return static_cast<int>(launch_fwd_c<1024>(*p, is_bf16, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ln_dense_bwd(const LndParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->cols != 256 && p->cols != 512 && p->cols != 768 && p->cols != 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) {
    const dim3 grid(p->cols / kBN, static_cast<unsigned>((p->rows + kBM - 1) / kBM));
    vitae_lnd_dln_bf16_kernel<<<grid, kThreads, 0, s>>>(*p);
  } else {
    const dim3 grid(p->cols / kF32BN, static_cast<unsigned>((p->rows + kF32BM - 1) / kF32BM));
    vitae_lnd_dln_f32_kernel<<<grid, kThreads, 0, s>>>(*p);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const lnrows::RowBwdArgs a{p->x, p->dln, p->gamma, p->mu, p->rstd, p->dx, p->rows};
  return static_cast<int>(is_bf16 ? lnrows::launch_rows_bwd<__nv_bfloat16, float>(a, p->cols, s)
                                  : lnrows::launch_rows_bwd<float, float>(a, p->cols, s));
}

const char* ln_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
