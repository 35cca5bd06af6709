// Row passes shared by the LayerNorm kernels (layernorm.cu) and the
// LayerNorm+Dense kernels (ln_dense.cu): one warp holds one row of C
// features in registers, as f32.
//
// Layout: lane `l` holds the 16-byte vectors l, l + 32, l + 64, ... of its
// row (8 bf16 or 4 f32 elements each), so every load and store of a warp
// covers 512 contiguous bytes. C must be a multiple of 32 vectors: 256 for
// bf16 and 128 for f32; the kernels are instanced at C = 256, 512, 768 and
// 1024 (kernels/fused_ln.py LN_WIDTHS).
//
// Statistics follow the TPU kernels (fused_ln.py _ln_fwd_kernel,
// fused_ln_dense.py _lnd_fwd_kernel): mean and the fast variance
// E[x^2] - mean^2 in f32, not clamped, rstd = rsqrt(var + eps).
#pragma once

#include "flash_common.cuh"

namespace lnrows {

template <typename T>
struct Vec;
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};
template <>
struct Vec<float> {
  static constexpr int N = 4;
};

// Vectors per lane for a row of C elements of T, and the elements in each.
template <typename T, int C>
struct RowShape {
  static constexpr int V = Vec<T>::N;
  static constexpr int J = C / (32 * V);
  static_assert(C % (32 * V) == 0, "C must be a multiple of 32 vectors");
};

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  static_assert(V == 8, "one 16-byte vector of bf16");
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  static_assert(V == 8, "one 16-byte vector of bf16");
  uint4 q;
  uint32_t* w = reinterpret_cast<uint32_t*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = flash::pack_f32(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Column of element e of vector j held by `lane`.
template <int V>
__device__ __forceinline__ int col_of(int j, int lane) {
  return (j * 32 + lane) * V;
}

// (mean, rstd) of a row of C elements whose vectors the warp holds in v.
template <int C, int J, int V>
__device__ __forceinline__ float2 stats_of(const float (&v)[J][V], float eps) {
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s += v[j][e];
      ss = fmaf(v[j][e], v[j][e], ss);
    }
  }
  const float mu = warp_sum(s) / C;
  const float var = warp_sum(ss) / C - mu * mu;  // fast variance, not clamped
  return make_float2(mu, rsqrtf(var + eps));
}

// Loads one row into v (as f32) -> (mean, rstd).
template <typename T, int C>
__device__ __forceinline__ float2 row_stats(const T* row, float (&v)[RowShape<T, C>::J][RowShape<T, C>::V],
                                            int lane, float eps) {
  constexpr int V = RowShape<T, C>::V;
  constexpr int J = RowShape<T, C>::J;
#pragma unroll
  for (int j = 0; j < J; ++j) load_vec<V>(row + col_of<V>(j, lane), v[j]);
  return stats_of<C>(v, eps);
}

// v <- ((v - mu) * rstd) * gam + bet, in place, with the lane's gamma and
// beta already in registers.
template <int V, int J>
__device__ __forceinline__ void normalize_with(float (&v)[J][V], float2 st, const float (&gam)[J][V],
                                               const float (&bet)[J][V]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) v[j][e] = ((v[j][e] - st.x) * st.y) * gam[j][e] + bet[j][e];
  }
}

// The lane's vectors of a (C,) f32 parameter.
template <int V, int J>
__device__ __forceinline__ void load_lane(const float* param, float (&out)[J][V], int lane) {
#pragma unroll
  for (int j = 0; j < J; ++j) load_vec<V>(param + col_of<V>(j, lane), out[j]);
}

// v <- ((v - mu) * rstd) * gamma + beta, in place, for the vectors of one lane.
template <int V, int J>
__device__ __forceinline__ void normalize(float (&v)[J][V], float2 st, const float* gamma,
                                          const float* beta, int lane) {
  float gam[J][V], bet[J][V];
  load_lane(gamma, gam, lane);
  load_lane(beta, bet, lane);
  normalize_with(v, st, gam, bet);
}

struct RowBwdArgs {
  const void* x;       // (R, C) in T
  const void* grad;    // (R, C): dy in T (LayerNorm) or dln in f32 (LayerNorm+Dense)
  const float* gamma;  // (C,)
  const float* mu;     // (R,) from the forward
  const float* rstd;   // (R,)
  void* dx;            // (R, C) in T
  long long rows;
};

constexpr int kRowThreads = 256;  // 8 warps, one row each

// dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), g = grad * gamma,
// xhat = (x - mu) * rstd: the TPU kernels' row pass (fused_ln.py
// _ln_bwd_kernel, fused_ln_dense.py _lnd_bwd_kernel). Rows past R are not
// read or stored.
template <typename T, typename G, int C>
__global__ void __launch_bounds__(kRowThreads) vitae_ln_rows_bwd_kernel(const RowBwdArgs a) {
  constexpr int V = RowShape<T, C>::V;
  constexpr int J = RowShape<T, C>::J;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= a.rows) return;  // whole warps leave together
  const T* xr = static_cast<const T*>(a.x) + row * C;
  const G* gr = static_cast<const G*>(a.grad) + row * C;
  const float mu = a.mu[row];
  const float rstd = a.rstd[row];
  float xh[J][V], g[J][V];
  float sg = 0.f, sgx = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float gam[V];
    load_vec<V>(xr + col_of<V>(j, lane), xh[j]);
    load_vec<V>(gr + col_of<V>(j, lane), g[j]);
    load_vec<V>(a.gamma + col_of<V>(j, lane), gam);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      xh[j][e] = (xh[j][e] - mu) * rstd;
      g[j][e] *= gam[e];
      sg += g[j][e];
      sgx = fmaf(g[j][e], xh[j][e], sgx);
    }
  }
  const float mg = warp_sum(sg) / C;
  const float mgx = warp_sum(sgx) / C;
  T* dxr = static_cast<T*>(a.dx) + row * C;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < V; ++e) g[j][e] = rstd * (g[j][e] - mg - xh[j][e] * mgx);
    store_vec<V>(dxr + col_of<V>(j, lane), g[j]);
  }
}

template <typename T, typename G>
cudaError_t launch_rows_bwd(const RowBwdArgs& a, int cols, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((a.rows + kRowThreads / 32 - 1) / (kRowThreads / 32)));
  switch (cols) {
    case 256: vitae_ln_rows_bwd_kernel<T, G, 256><<<grid, kRowThreads, 0, stream>>>(a); break;
    case 512: vitae_ln_rows_bwd_kernel<T, G, 512><<<grid, kRowThreads, 0, stream>>>(a); break;
    case 768: vitae_ln_rows_bwd_kernel<T, G, 768><<<grid, kRowThreads, 0, stream>>>(a); break;
    case 1024: vitae_ln_rows_bwd_kernel<T, G, 1024><<<grid, kRowThreads, 0, stream>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace lnrows
