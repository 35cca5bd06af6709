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
// above the H100's ~295 FLOP/byte ridge; and it takes one exponential per
// score, 2.87e8 of them, on the SFU's 16 a clock and SM (about 3.9e12 a
// second): 0.074 ms, as long as the 0.074 ms of its bf16 products at 989
// TFLOP/s. At d = 32 the exponentials take twice as long as the products.
// So the tensor cores and the exponentials have to run at once, and the N
// x N scores stay out of device memory (online softmax over 64-key tiles
// in registers).
//
// Design of the bf16 kernel (flash_fwd_wgmma_kernel, wgmma + TMA): a block
// per (b, h, 64 query rows): one consumer warpgroup and one producer warp,
// three blocks an SM at d = 64 and four at d = 32 (two at d = 128), so
// that one warpgroup's softmax runs while the others' products are on the
// tensor cores. The producer loads the Q tile once by TMA and streams
// 64-key K and V tiles through a ring of stages (4 at d = 32, 3 at 64, 2
// at 128) behind full/empty mbarriers, rank-4 tensor maps over (d, token,
// head, batch) built from the wrapper's strides (flash_sm90.cuh); its
// lanes write each stage's key bias (log2 units) beside it. The key tiles
// are walked last to first: the ragged one, whose keys past kv_len are
// masked, is the peeled first step, and the loop over whole tiles has no
// branch between its products (a branch there makes ptxas serialise every
// wgmma). Per tile the warpgroup issues S = Q K^T (wgmma m64n64k16, both
// operands K-major), then the tile before's O += P V (m64n{d}k16, P from
// registers, V read MN-major through the transpose flag), and once S has
// landed runs this tile's softmax: the row max (of the raw scores, times
// the scale, without a bias), alpha = exp2(m_old - m_new), P = exp2(S
// scale log2(e) - m) as one FMA a score, summed into l in f32 and rounded
// to bf16 straight into the register A fragments of the next P V. O is
// scaled by alpha once the P V before has retired. (ptxas places that
// wait before the exponentials, which rewrite registers the products
// used: inside a warpgroup only the row max overlaps P V, and the
// exponentials overlap the other blocks' products.) Epilogue: o / l in
// bf16, lse = (m + log2 l) ln 2 in f32. Ragged tails arrive zero-filled
// from TMA; nothing is stored past seq_len.
//
// The f32 kernel (compute_dtype float32, TrainConfig's default) keeps
// f32-accurate products on the tensor cores with 3xTF32 (flash_common.cuh):
// each operand split into a TF32 high and low part, hi*hi + hi*lo + lo*hi
// summed in f32 by mma.sync m16n8k8, lo*lo dropped (about 2^-22 relative per
// product, inside kernel_tolerance's 1e-5 where plain TF32's 2^-11 is not).
// Bound: 3 x 4*B*H*N*Nk*d TF32 operations, so the card's 495 TFLOP/s of
// TF32 give 165 of f32-accurate work. 4 warps x 16 query rows, 64-key
// tiles, online softmax in the log2 domain, with K and V tiles in f32
// double-buffered through cp.async, rows padded by 4 floats for
// conflict-free fragment reads (70 KB at d = 64, so dynamic shared
// memory). Operands need 16-byte aligned rows (the wrapper checks).

#include "flash_sm90.cuh"


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


// The bf16 kernel's block: one consumer warpgroup on a 64-row Q tile and
// a producer warp, a ring of 64-key K/V stages; tiles of flash_sm90.cuh's
// geometry. Several blocks share an SM, so that one warpgroup's softmax
// runs beside the others' products.
template <int D>
struct FwdTiling {
  using Tile = BwdTiling<D>;
  static constexpr int kStages = D == 32 ? 4 : (D == 64 ? 3 : 2);
  // blocks an SM holds: 65,536 registers over 160 threads a block (and shared memory)
  static constexpr int kMinBlocks = D == 32 ? 4 : (D == 64 ? 3 : 2);
  // [Q tile][kStages x (K, V) tiles][kStages x 64 f32 key bias][barriers],
  // after 1,024 bytes of alignment room; the SM keeps 1 KB a block besides
  static constexpr int kStageOffset = Tile::kTileBytes;
  static constexpr int kBiasOffset = kStageOffset + kStages * 2 * Tile::kTileBytes;
  static constexpr int kBarOffset = kBiasOffset + kStages * kBlock * 4;
  static constexpr int kSmem = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert((kSmem + 1024) * kMinBlocks <= 228 * 1024, "over the shared memory of an SM");
};

// S = Q K^T for one 64-key stage: this warpgroup's 64 query rows x 64 keys,
// both operands K-major (their rows hold the depth d).
template <int D>
__device__ __forceinline__ void s_product(float (&s)[32], const unsigned char* qs, const unsigned char* ks) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) sm90::Wgmma<64>::ss<0>(s, desc_k<D>(qs, kk), desc_k<D>(ks, kk), kk > 0);
}

// O += P V over one 64-key stage: P (this warpgroup's 64 rows x 64 keys)
// from registers, V's tile read MN-major (its keys are the depth).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pa)[4][4], const unsigned char* vs) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::Wgmma<D>::template rs<1>(o, pa[kk], desc_mn<D>(vs, kk), 1);
}

// The max of each of this thread's two rows over the quad that shares
// them: this thread's 16 values of a row (element 4j + e is row g + 8 (e >>
// 1)) by a pairwise tree, then two shuffles.
__device__ __forceinline__ void row_max(const float (&x)[32], float (&out)[2]) {
  float a[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) a[r][j] = fmaxf(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r][j] = fmaxf(a[r][j], a[r][j + w]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    out[r] = fmaxf(a[r][0], __shfl_xor_sync(0xffffffffu, a[r][0], 1));
    out[r] = fmaxf(out[r], __shfl_xor_sync(0xffffffffu, out[r], 2));
  }
}

// This thread's share of each row's sum, by a pairwise tree.
__device__ __forceinline__ void row_sum(const float (&x)[32], float (&out)[2]) {
  float a[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) a[r][j] = x[4 * j + 2 * r] + x[4 * j + 2 * r + 1];
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1) {
#pragma unroll
    for (int j = 0; j < w; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) a[r][j] += a[r][j + w];
    }
  }
  out[0] = a[0][0];
  out[1] = a[1][0];
}

// The running max m (log2 units) meets a tile's max mx: alpha = exp2(m -
// m_new) rescales l (and, once the P V before has retired, O). Every tile
// holds key k0 < kv_len, so mx is finite from the first tile on (alpha 0
// there); a pad key's bias is finite, so a tile of pad keys alone gives a
// finite max and p = 1 for each.
__device__ __forceinline__ void new_max(float (&m)[2], const float (&mx)[2], float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
}

// This thread's 32 scores of a tile (element 4j + e: row g + 8 (e >> 1),
// key k0 + 8j + 2t + (e & 1)) as they enter the row max: negated with NEG,
// keys past kv_len at -inf with MASK.
template <bool NEG, bool MASK>
__device__ __forceinline__ void raw_max(const float (&s)[32], float (&mx)[2], int k0, int keys, int t) {
  float x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = NEG ? -s[i] : s[i];
    if constexpr (MASK) x[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= keys ? -INFINITY : x[i];
  }
  row_max(x, mx);
}

// Online softmax of one 64-key tile in the accumulator layout, in log2
// units: the tile's row max of x = S scale log2(e) + b (b the key bias in
// log2 units, or none; without one, the scale times the raw scores' max,
// or their min for a negative scale: the max of the rounded products, as
// rounding keeps order), with MASK keys past kv_len left out; the new
// running max m and alpha = exp2(m_old - m) (l scaled by it); then P =
// exp2(fma(S, scale log2(e), -m)) for a key without bias (one FMA a score,
// the same arithmetic, bit for bit, in the instances with a key bias and
// without), exp2(x - m) for one with, in place of S (0 for a masked key),
// summed into l.
template <bool HAS_BIAS, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             float scale_log2, const float* bias, int k0, int keys, int t) {
  float b[16];  // the bias of keys 8j + 2t + (e & 1): b[2j + (e & 1)]
  float mx[2];
  float x[32];  // with a bias: S scale log2(e) + b, rounded
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
      b[2 * j] = bb.x;
      b[2 * j + 1] = bb.y;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      x[i] = fmaf(s[i], scale_log2, b[2 * (i >> 2) + (i & 1)]);
      if constexpr (MASK) x[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= keys ? -INFINITY : x[i];
    }
    row_max(x, mx);
  } else if (scale_log2 >= 0.f) {
    raw_max<false, MASK>(s, mx, k0, keys, t);
    mx[0] *= scale_log2;
    mx[1] *= scale_log2;
  } else {
    raw_max<true, MASK>(s, mx, k0, keys, t);
    mx[0] *= -scale_log2;
    mx[1] *= -scale_log2;
  }
  new_max(m, mx, l, alpha);
  const float neg_m[2] = {-m[0], -m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float y = fmaf(s[i], scale_log2, neg_m[(i >> 1) & 1]);
    // a key with a bias takes x - m: a pad key's -1e30 absorbs its score,
    // as in the plain version (a block of pad keys alone: p = 1 for each)
    if constexpr (HAS_BIAS) y = b[2 * (i >> 2) + (i & 1)] == 0.f ? y : x[i] - m[(i >> 1) & 1];
    s[i] = ex2(y);
    if constexpr (MASK) s[i] = k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= keys ? 0.f : s[i];
  }
  float sum[2];
  row_sum(s, sum);
  l[0] += sum[0];
  l[1] += sum[1];
}

template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kWsThreads, FwdTiling<D>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const FlashFwdParams p) {
  using F = FwdTiling<D>;
  using T = BwdTiling<D>;
  using namespace sm90;
  constexpr int kStages = F::kStages;
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* base = fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  unsigned char* stages = base + F::kStageOffset;  // stage s: K at tile 2s, V at 2s + 1
  float* bias_s = reinterpret_cast<float*>(base + F::kBiasOffset);  // stage s: [64s, +64), log2 units
  uint64_t* full = reinterpret_cast<uint64_t*>(base + F::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = p.seq_len;
  const int keys = p.kv_len;
  const int ktiles = (keys + kBlock - 1) / kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], HAS_BIAS ? 1 + 32 : 1);  // and the producer lanes' bias
      mbar_init(&empty[s], 1);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    const uint64_t shared_by_all = l2_evict_last();  // every query block of the head reads K and V
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_k);
      tma_prefetch_descriptor(&tm_v);
      const uint64_t once = l2_evict_first();
      mbar_arrive_expect_tx(qbar, T::kTileBytes);
      load_rows<D>(base, &tm_q, q0, h, b, qbar, once);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = ktiles - 1; kt >= 0; --kt) {  // last to first, as the consumers walk them
      mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: every stage starts empty
      const int k0 = kt * kBlock;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes);
        load_rows<D>(stages + 2 * stage * T::kTileBytes, &tm_k, k0, h, b, &full[stage], shared_by_all);
        load_rows<D>(stages + (2 * stage + 1) * T::kTileBytes, &tm_v, k0, h, b, &full[stage], shared_by_all);
      }
      if constexpr (HAS_BIAS) {
        float* bs = bias_s + stage * kBlock;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + lane + 32 * i;
          bs[lane + 32 * i] = key < keys ? p.key_bias[key] * kLog2e : 0.f;
        }
        mbar_arrive(&full[stage]);
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int t = lane & 3;
  const unsigned char* qs = base;
  const float scale_log2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // rows g and g + 8 of the warp (g = lane / 4): running max (log2 units)
  // and this thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float s[32];        // S, then P, of the current key tile: 64 rows x 64 keys
  uint32_t pa[4][4];  // P of the tile before, in bf16: the register A of its P V
  float alpha[2];
  mbar_wait(qbar, 0);

  // The ragged last tile first, keys past kv_len masked; then the whole
  // tiles, last to first, with no branch between the products
  int stage = 0;
  uint32_t phase = 0;
  mbar_wait(&full[stage], phase);
  wgmma_fence();
  s_product<D>(s, qs, stages + 2 * stage * T::kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(s);
  softmax_tile<HAS_BIAS, true>(s, m, l, alpha, scale_log2, bias_s + stage * kBlock, (ktiles - 1) * kBlock, keys, t);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
  int prev = stage;
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
  for (int kt = ktiles - 2; kt >= 0; --kt) {
    mbar_wait(&full[stage], phase);
    fence_operands(o);
    wgmma_fence();
    s_product<D>(s, qs, stages + 2 * stage * T::kTileBytes);
    wgmma_commit();
    pv_product<D>(o, pa, stages + (2 * prev + 1) * T::kTileBytes);  // the tile before's, beside this softmax
    wgmma_commit();
    fence_operands(o);
    wgmma_wait<1>();
    fence_operands(s);
    softmax_tile<HAS_BIAS, false>(s, m, l, alpha, scale_log2, bias_s + stage * kBlock, kt * kBlock, keys, t);
    wgmma_wait<0>();  // the tile before's P V has retired: its stage is free, O may be scaled
    fence_operands(o);
    fence_frags(pa);
    if (threadIdx.x == 0) mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, pa[kk]);
    prev = stage;
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  fence_operands(o);
  wgmma_fence();
  pv_product<D>(o, pa, stages + (2 * prev + 1) * T::kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
  fence_frags(pa);

  const int g = lane >> 2;
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
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + (long long)row * p.o_sn + h * p.o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(og + j * 8) = pack_f32(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)b * p.heads + h) * n + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, bool HAS_BIAS>
cudaError_t launch_bf16(const FlashFwdParams& p, cudaStream_t stream) {
  using F = FwdTiling<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (encode_rows<D>(&tm_q, p.q, p.q_sb, p.q_sn, p.q_sh, p.seq_len, p.heads, p.batch) != CUDA_SUCCESS ||
      encode_rows<D>(&tm_k, p.k, p.k_sb, p.k_sn, p.k_sh, p.kv_len, p.heads, p.batch) != CUDA_SUCCESS ||
      encode_rows<D>(&tm_v, p.v, p.v_sb, p.v_sn, p.v_sh, p.kv_len, p.heads, p.batch) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, HAS_BIAS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlock - 1) / kBlock, p.heads, p.batch);
  flash_fwd_wgmma_kernel<D, HAS_BIAS><<<grid, kWsThreads, F::kSmem, stream>>>(tm_q, tm_k, tm_v, p);
  return cudaGetLastError();
}

// ----------------------------------------------------------------- f32 path

constexpr int kBlockQ = 64;  // query rows per block: 4 warps x 16 rows
constexpr int kBlockK = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;

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
  if (is_bf16) return launch_bf16<D, HAS_BIAS>(p, stream);
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, HAS_BIAS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq_len + kBlockQ - 1) / kBlockQ, p.heads, p.batch);
  flash_fwd_f32_kernel<D, HAS_BIAS><<<grid, kThreads, smem, stream>>>(p);
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
