// LayerNorm forward and backward for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (vit_ae_plus_plus_torch/kernels/_build.py).
//
// Replaces the two TPU kernels of the JAX package's kernels/fused_ln.py:
//   - _fwd_cp (_ln_fwd_kernel): y = (x - mu) * rstd * gamma + beta over the
//     last axis, with mu and rstd emitted in f32;
//   - _bwd_cp (_ln_bwd_kernel): dx = rstd * (g - mean(g) - xhat * mean(g *
//     xhat)), g = dy * gamma. dgamma and dbeta are row sums outside the
//     kernel, as in JAX (kernels/fused_ln.py of the port).
// Statistics are f32 for bf16 and f32 inputs: mean and the fast variance
// E[x^2] - mean^2, not clamped (csrc/ln_rows.cuh).
//
// What bounds it: a LayerNorm reads x (and dy) once and writes y (or dx)
// once, a few operations per byte: memory-bound. The design keeps each row
// in one warp's registers (16-byte loads, 512 contiguous bytes per warp
// instruction), reduces with shuffles, and touches device memory once per
// operand. The TPU kernel's ones-vector matmuls for the row means (its lane
// reductions were slow) and its (1, R) lane-oriented statistics were TPU
// layout choices; here mu and rstd are (R,) f32.

#include "ln_rows.cuh"

struct LnParams {
  const void* x;       // (R, C) in T
  const void* dy;      // (R, C) in T, backward only
  const float* gamma;  // (C,)
  const float* beta;   // (C,), forward only
  void* y;             // (R, C) in T, forward
  void* dx;            // (R, C) in T, backward
  float* mu;           // (R,)
  float* rstd;         // (R,)
  long long rows;
  int cols;
  float eps;
};

namespace {

using namespace lnrows;

template <typename T, int C>
__global__ void __launch_bounds__(kRowThreads) vitae_ln_fwd_kernel(const LnParams p) {
  constexpr int V = RowShape<T, C>::V;
  constexpr int J = RowShape<T, C>::J;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  float v[J][V];
  const float2 st = row_stats<T, C>(static_cast<const T*>(p.x) + row * C, v, lane, p.eps);
  normalize(v, st, p.gamma, p.beta, lane);
  T* yr = static_cast<T*>(p.y) + row * C;
#pragma unroll
  for (int j = 0; j < J; ++j) store_vec<V>(yr + col_of<V>(j, lane), v[j]);
  if (lane == 0) {
    p.mu[row] = st.x;
    p.rstd[row] = st.y;
  }
}

template <typename T>
cudaError_t launch_fwd(const LnParams& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.rows + kRowThreads / 32 - 1) / (kRowThreads / 32)));
  switch (p.cols) {
    case 256: vitae_ln_fwd_kernel<T, 256><<<grid, kRowThreads, 0, stream>>>(p); break;
    case 512: vitae_ln_fwd_kernel<T, 512><<<grid, kRowThreads, 0, stream>>>(p); break;
    case 768: vitae_ln_fwd_kernel<T, 768><<<grid, kRowThreads, 0, stream>>>(p); break;
    case 1024: vitae_ln_fwd_kernel<T, 1024><<<grid, kRowThreads, 0, stream>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `device`'s `stream` and returns the CUDA error (0 on success).
int layernorm_fwd(const LnParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? launch_fwd<__nv_bfloat16>(*p, s) : launch_fwd<float>(*p, s));
}

int layernorm_bwd(const LnParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const lnrows::RowBwdArgs a{p->x, p->dy, p->gamma, p->mu, p->rstd, p->dx, p->rows};
  return static_cast<int>(is_bf16 ? lnrows::launch_rows_bwd<__nv_bfloat16, __nv_bfloat16>(a, p->cols, s)
                                  : lnrows::launch_rows_bwd<float, float>(a, p->cols, s));
}

const char* layernorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
