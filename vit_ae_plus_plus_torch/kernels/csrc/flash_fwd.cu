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
// The f32 body (compute_dtype float32, TrainConfig's default) keeps
// f32-accurate products on the tensor cores with 3xTF32 (flash_common.cuh):
// each operand split into a TF32 high and low part, hi*hi + hi*lo + lo*hi
// summed in f32, lo*lo dropped (about 2^-22 relative per product, inside
// kernel_tolerance's 1e-5 where plain TF32's 2^-11 is not). Bound: 3 x
// 4*B*H*N*Nk*d TF32 operations, so the card's 495 TFLOP/s of TF32 give 165
// of f32-accurate work. It runs on tf32 wgmma and TMA, built from the f32
// backward's blocks (flash_sm90.cuh), in two launches:
//   1. a split pre-pass (flash_fwd_split_kernel) writes tf32 hi and lo
//      copies of K (row-major) and a transposed hi and lo copy of V (d rows
//      of tokens, the token axis padded to 8 and each 8-token group
//      permuted by tf32_token) into scratch the wrapper allocates at the
//      size flash_fwd_split_floats reports. tf32 wgmma reads only K-major
//      shared operands, and O += P V has the keys as its depth: V^T is that
//      operand, and with the permutation P's accumulator columns land as
//      its tf32 A fragment (acc_to_tf32_a) with no shuffle. Q is read once
//      by one block, so it skips the pre-pass: TMA loads it in f32 and its
//      warpgroup splits it in shared memory (the pre-pass moves 6 of the 9
//      operand-sized passes it would with Q);
//   2. the main kernel (flash_fwd_tf32_kernel): a block per (b, h, 64 *
//      kCons query rows), kCons consumer warpgroups of 64 rows and one
//      producer warp. The producer loads each warpgroup's Q once (it stays
//      resident, hi and lo) and streams K hi, K lo, V^T hi and V^T lo in
//      stages of kRows keys through a ring behind full/empty mbarriers, its
//      lanes writing a ring step's key bias (log2 units) beside each stage.
//      Per stage a warpgroup runs S = Q K^T as 3xTF32 over d in one
//      accumulator (m64n{kRows}k8, both operands K-major; at d = 128 two
//      accumulators of 64 dims added at nearest, as the backward's
//      scores_split), the online softmax in the log2 domain (ex2.approx,
//      the ragged key tail masked by a select on every stage, no branch
//      between the products), splits P into tf32 A fragments on the ALU
//      (split_tf32_alu) and runs P V as 3xTF32 into a fresh accumulator
//      (m64n{d}k8, B = V^T), which is added to O on the FMA pipes after O
//      is scaled by alpha. The tensor cores' f32 sums truncate: one
//      accumulator over 1,729 keys would drift by about 1e-5 (the CPU
//      witness's control), a stage's 24 or 12 products stay a few 2^-24
//      off.
// Sizes (shared memory: a 64-row f32 tile is 16 KiB at d = 64, twice that
// with its lo copy):
//   d      kCons  stage  stages  resident Q  ring     registers (o, chunk, S, P)
//   32     2      64     4       32 KiB      128 KiB  16 + 16 + 32 + 64
//   64     2      64     2       64 KiB      128 KiB  32 + 32 + 32 + 64
//   128    1      32     2       64 KiB      128 KiB  64 + 64 + 32 + 32
// At d = 32 and 64 two warpgroups share each stage: one alone would pull
// about 40 bytes a clock from L2 at the full tf32 rate (the backward's
// header has the reckoning), and one's softmax runs beside the other's
// products. At d = 128 two resident Q tiles and a 64-key stage would not
// fit, so one warpgroup takes 32-key stages. One block an SM. A warpgroup
// whose 64 rows all lie past seq_len only releases the stages. Ragged
// tails arrive zero-filled from TMA; nothing is stored past seq_len.
// Not done: issuing the next stage's S beside this stage's P V (the bf16
// body's overlap) needs a second S and P in registers, and ptxas holds a
// 288-thread block to 168 a thread (it rounds to whole warpgroups): that
// version spilled and ran slower.
// Operands need 16-byte aligned rows (the wrapper checks; the bf16 TMA
// maps need them).

#include "flash_sm90.cuh"


struct FlashFwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, seq_len) f32, or null
  const float* key_bias;  // (kv_len,) f32 additive bias over the keys, or null
  float* split;  // scratch of flash_fwd_split_floats floats (the f32 body's tf32 copies), or null
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
//
// 3xTF32 on tf32 wgmma + TMA (design in the header comment).

// The pre-pass's copies, float offsets into the wrapper's scratch
// (flash_fwd_split_floats sizes it), each hi at [0] and lo at [1] of its
// outer axis: ks (2, BH, kv_len, D) row-major; vt (2, BH, D, npk)
// transposed, the token axis padded to a multiple of 8 (zeros) and
// permuted within each 8-token group by tf32_token.
struct FwdSplit {
  long long ks, vt, end;
  long long bh, npk;
};

__host__ __device__ inline FwdSplit fwd_split(const FlashFwdParams& p) {
  FwdSplit s;
  s.bh = (long long)p.batch * p.heads;
  s.npk = pad8(p.kv_len);
  s.ks = 0;
  s.vt = s.ks + 2 * s.bh * p.kv_len * p.head_dim;
  s.end = s.vt + 2 * s.bh * p.head_dim * s.npk;
  return s;
}

// One (b, h, 32-key tile) a block: the K and V rows loaded 16 bytes a
// thread, all loads before any store; K's rows split into tf32 hi and lo
// (cvt.rna), V's transposed copy through a shared-memory tile, its writes
// along the token axis coalesced.
template <int D>
__global__ void __launch_bounds__(256) flash_fwd_split_kernel(const FlashFwdParams p) {
  constexpr int kVec = kTfRows * D / 4 / 256;  // float4s a thread of each operand
  __shared__ float tile[kTfRows][D + 1];
  const FwdSplit s = fwd_split(p);
  const int t0 = blockIdx.x * kTfRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * p.heads + h;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float4 kx[kVec], vx[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = (threadIdx.x + 256 * i) * 4;  // element e .. e + 3 of the tile, along a row
    const int row = t0 + e / D;
    const bool live = row < p.kv_len;
    kx[i] = live ? *reinterpret_cast<const float4*>(kg + row * p.k_sn + e % D) : make_float4(0.f, 0.f, 0.f, 0.f);
    vx[i] = live ? *reinterpret_cast<const float4*>(vg + row * p.v_sn + e % D) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float* ks = p.split + s.ks;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int e = (threadIdx.x + 256 * i) * 4;
    const int r = e / D;
    const int c = e % D;
    tile[r][c] = vx[i].x;
    tile[r][c + 1] = vx[i].y;
    tile[r][c + 2] = vx[i].z;
    tile[r][c + 3] = vx[i].w;
    if (t0 + r >= p.kv_len) continue;
    const Tf32x2 x = split_tf32(kx[i].x), y = split_tf32(kx[i].y), z = split_tf32(kx[i].z), w = split_tf32(kx[i].w);
    const long long at = (bh * p.kv_len + t0 + r) * D + c;
    *reinterpret_cast<float4*>(ks + at) = make_float4(__uint_as_float(x.hi), __uint_as_float(y.hi),
                                                      __uint_as_float(z.hi), __uint_as_float(w.hi));
    *reinterpret_cast<float4*>(ks + s.bh * p.kv_len * D + at) =
        make_float4(__uint_as_float(x.lo), __uint_as_float(y.lo), __uint_as_float(z.lo), __uint_as_float(w.lo));
  }
  __syncthreads();
  float* vt = p.split + s.vt;
  for (int i = threadIdx.x; i < kTfRows * D; i += 256) {
    const int c = i / kTfRows;
    const int pos = i % kTfRows;
    if (t0 + pos >= s.npk) continue;
    const Tf32x2 v = split_tf32(tile[(pos & ~7) + tf32_token(pos & 7)][c]);
    vt[(bh * D + c) * s.npk + t0 + pos] = __uint_as_float(v.hi);
    vt[((s.bh + bh) * D + c) * s.npk + t0 + pos] = __uint_as_float(v.lo);
  }
}

// The main kernel's block: [kCons x (Q hi, Q lo)][kStages x (K hi, K lo,
// V^T hi, V^T lo)][kStages x kRows f32: the stage's key bias][barriers],
// after 1,024 bytes of alignment room. TMA writes each Q tile in f32 into
// its lo slot; its warpgroup splits it in place.
template <int D>
struct Tf32Fwd {
  static constexpr int kCons = D == 128 ? 1 : 2;     // consumer warpgroups: a block owns 64 * kCons queries
  static constexpr int kThreads = kCons * 128 + 32;  // and a producer warp
  static constexpr int kRows = D == 128 ? 32 : 64;   // keys a stage: the depth of a P V chunk
  static constexpr int kStages = D == 32 ? 4 : 2;
  static constexpr int kResBytes = kBlock * D * 4;  // a resident Q tile, hi or lo
  static constexpr int kRowBytes = kRows * D * 4;   // a streamed K tile, or a V^T tile (D rows of kRows tokens)
  static constexpr int kStageOffset = kCons * 2 * kResBytes;
  static constexpr int kBiasOffset = kStageOffset + kStages * 4 * kRowBytes;
  static constexpr int kBarOffset = kBiasOffset + kStages * kRows * 4;
  static constexpr int kSmem = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// Online softmax of one stage of S in the accumulator layout (element 4j
// + e: query row g (+ 8 for e >= 2), key k0 + 8j + 2t + (e & 1)), in log2
// units: x = S scale log2(e) + the key bias (log2 units, or none), keys
// past kv_len at -inf (a select, no branch); the new running max m,
// alpha = exp2(m_old - m) (l scaled by it), then P = exp2(x - m) in place
// of S, summed into l.
template <int R, bool HAS_BIAS>
__device__ __forceinline__ void softmax_stage(float (&s)[R / 2], float (&m)[2], float (&l)[2], float (&alpha)[2],
                                              float scale2, const float* bias, int k0, int nk, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * t + (e & 1);
      float x = key < nk ? s[4 * j + e] * scale2 : -INFINITY;
      if constexpr (HAS_BIAS) x += bias[8 * j + 2 * t + (e & 1)];
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    s[i] = ex2(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// o and lse of 64 * kCons query rows, warpgroup w owning rows 64w .. 64w +
// 63 of the block: per stage of kRows keys S = Q K^T, the online softmax,
// P split into tf32 A fragments, P V (B = the permuted V^T) into a fresh
// accumulator added to O after O is scaled by alpha.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(Tf32Fwd<D>::kThreads, 1)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_vt, const FlashFwdParams p) {
  using F = Tf32Fwd<D>;
  using namespace sm90;
  constexpr int kStages = F::kStages;
  constexpr int kRows = F::kRows;
  constexpr int kRes = F::kResBytes;
  constexpr int kRow = F::kRowBytes;
  extern __shared__ unsigned char fwd_smem[];
  unsigned char* base = fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  unsigned char* stream = base + F::kStageOffset;  // stage s: its four tiles from stream + 4s kRow
  float* bias_s = reinterpret_cast<float*>(base + F::kBiasOffset);  // stage s: [kRows s, +kRows), log2 units
  uint64_t* full = reinterpret_cast<uint64_t*>(base + F::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * kBlock * F::kCons;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const int ktiles = (nk + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], HAS_BIAS ? 1 + 32 : 1);  // and the producer lanes' bias
      mbar_init(&empty[s], F::kCons);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * F::kCons) {  // the producer warp
    const uint64_t once = l2_evict_first();
    const uint64_t shared_by_all = l2_evict_last();  // every query block of the head reads K and V^T
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_k);
      tma_prefetch_descriptor(&tm_vt);
      mbar_arrive_expect_tx(qbar, F::kCons * kRes);
      for (int w = 0; w < F::kCons; ++w) {  // Q in f32 from the caller's strides, into the lo slot
#pragma unroll
        for (int kb = 0; kb < D / 32; ++kb) {
          tma_load_4d(base + (2 * w + 1) * kRes + kb * kBlock * 128, &tm_q, kb * 32, q0 + kBlock * w, h, b, qbar,
                      once);
        }
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: every stage starts empty
      const int k0 = kt * kRows;
      unsigned char* st = stream + 4 * stage * kRow;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 4 * kRow);
        for (int hl = 0; hl < 2; ++hl) {
          load_split_rows<D, kRows>(st + hl * kRow, &tm_k, k0, bh, hl, &full[stage], shared_by_all);
          for (int kb = 0; kb < kRows / 32; ++kb) {  // V^T: D rows of 32 tokens a box
            tma_load_4d(st + (2 + hl) * kRow + kb * D * 128, &tm_vt, k0 + 32 * kb, 0, bh, hl, &full[stage],
                        shared_by_all);
          }
        }
      }
      if constexpr (HAS_BIAS) {
        for (int i = lane; i < kRows; i += 32) {
          const int key = k0 + i;
          bias_s[stage * kRows + i] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
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

  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool lead = (threadIdx.x & 127) == 0;
  const int row0 = q0 + kBlock * wg;
  int stage = 0;
  uint32_t phase = 0;
  if (row0 >= n) {  // every row of this warpgroup lies past seq_len: it only releases the stages
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[stage], phase);
      if (lead) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  const unsigned char* q_hi = base + 2 * wg * kRes;  // then Q lo
  const float scale2 = p.scale * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // rows g and g + 8 of the warp: running max (log2 units) and this
  // thread's share of the row sums
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  {  // split this warpgroup's Q tile: hi and lo at the same offsets (one layout), then visible to wgmma
    float4* qhi = reinterpret_cast<float4*>(base + 2 * wg * kRes);
    float4* qlo = reinterpret_cast<float4*>(base + (2 * wg + 1) * kRes);
    for (int i = threadIdx.x & 127; i < kRes / 16; i += 128) {
      const float4 x = qlo[i];
      const Tf32x2 a = split_tf32(x.x), c = split_tf32(x.y), e = split_tf32(x.z), f = split_tf32(x.w);
      qhi[i] = make_float4(__uint_as_float(a.hi), __uint_as_float(c.hi), __uint_as_float(e.hi), __uint_as_float(f.hi));
      qlo[i] = make_float4(__uint_as_float(a.lo), __uint_as_float(c.lo), __uint_as_float(e.lo), __uint_as_float(f.lo));
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = stream + 4 * stage * kRow;
    float s[kRows / 2], s2[kRows / 2];  // S, then P: 64 queries x kRows keys
    wgmma_fence();
    scores_split<D, kRows>(s, s2, q_hi, q_hi + kRes, st, st + kRow);
    wgmma_commit();
    wgmma_wait<0>();
    scores_join<D, kRows>(s, s2);
    float alpha[2];
    softmax_stage<kRows, HAS_BIAS>(s, m, l, alpha, scale2, bias_s + stage * kRows, kt * kRows, nk, t);
    uint32_t pa_hi[kRows / 8][4], pa_lo[kRows / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) acc_to_tf32_a<kRows / 2, true>(s, kk, pa_hi[kk], pa_lo[kk]);
    float chunk[D / 2];
    wgmma_fence();
    chunk_3xtf32<D, kRows>(chunk, pa_hi, pa_lo, st + 2 * kRow, st + 3 * kRow);  // P V, B = V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(chunk);
    fence_frags(pa_hi);
    fence_frags(pa_lo);
    if (lead) mbar_arrive(&empty[stage]);  // the warpgroup's products on the stage are done
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = fmaf(o[i], alpha[(i >> 1) & 1], chunk[i]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wl * 16 + g + 8 * r;
    if (row >= n) continue;  // dead query rows are not stored
    const float inv = 1.f / l[r];
    float* og = static_cast<float*>(p.o) + b * p.o_sb + (long long)row * p.o_sn + h * p.o_sh + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(og + j * 8) = make_float2(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[((long long)b * p.heads + h) * n + row] = (m[r] + log2f(l[r])) * kLn2;
    }
  }
}

template <int D, bool HAS_BIAS>
cudaError_t launch_tf32(const FlashFwdParams& p, cudaStream_t stream) {
  using F = Tf32Fwd<D>;
  if (p.split == nullptr) return cudaErrorInvalidValue;
  const FwdSplit s = fwd_split(p);
  flash_fwd_split_kernel<D><<<dim3((s.npk + kTfRows - 1) / kTfRows, p.heads, p.batch), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Q from the caller's (batch, token, head) strides, 64-row boxes of 32 f32
  const uint64_t q_dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(p.seq_len),
                              static_cast<uint64_t>(p.heads), static_cast<uint64_t>(p.batch)};
  const uint64_t q_strides[3] = {static_cast<uint64_t>(p.q_sn) * 4, static_cast<uint64_t>(p.q_sh) * 4,
                                 static_cast<uint64_t>(p.q_sb) * 4};
  const uint32_t q_box[4] = {32, static_cast<uint32_t>(kBlock), 1, 1};
  CUtensorMap tm_q, tm_k, tm_vt;
  if (sm90::encode(&tm_q, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.q, 4, q_dims, q_strides, q_box,
                   CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS ||
      encode_split(&tm_k, p.split + s.ks, s.bh, p.kv_len, D, F::kRows) != CUDA_SUCCESS ||
      encode_split(&tm_vt, p.split + s.vt, s.bh, D, s.npk, D) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<D, HAS_BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F::kSmem);
  if (err != cudaSuccess) return err;
  constexpr int kRowsABlock = kBlock * F::kCons;
  const dim3 grid((p.seq_len + kRowsABlock - 1) / kRowsABlock, p.heads, p.batch);
  flash_fwd_tf32_kernel<D, HAS_BIAS><<<grid, F::kThreads, F::kSmem, stream>>>(tm_q, tm_k, tm_vt, p);
  return cudaGetLastError();
}

template <int D, bool HAS_BIAS>
cudaError_t launch(const FlashFwdParams& p, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<D, HAS_BIAS>(p, stream) : launch_tf32<D, HAS_BIAS>(p, stream);
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

// Floats of the scratch `flash_fwd` reads from p->split for this call: the
// f32 body's tf32 copies (fwd_split), none in bf16.
long long flash_fwd_split_floats(const FlashFwdParams* p, int is_bf16) {
  return is_bf16 ? 0 : fwd_split(*p).end;
}

const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
