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
// What bounds it: 10 * B*H*N^2*d operations (five N x N x d products)
// against some 60 MB of operands at the decoder shape: far above the H100's
// ~295 FLOP/byte ridge, so the bound is tensor-core throughput. The N x N
// scores never reach device memory.
//
// Design of the bf16 bodies (Hopper: wgmma + TMA), deterministic and
// without atomics, three launches on one stream:
//   1. delta pre-pass: one warp per (b, h, row), delta = rowsum(do * o) in
//      f32 into a (B, H, N) scratch.
//   2. dK/dV kernel: a block per (b, h, 64-key tile): one consumer
//      warpgroup and one producer warp. The producer loads the block's K
//      and V once and streams every 64-query tile of Q and dO through a
//      ring of stages (2 to 4, by head_dim) with TMA, rank-4 tensor maps
//      over (d, token, head, batch) built from the wrapper's strides (the
//      packed view's token stride is 3C), behind full/empty mbarriers; its
//      lanes write each tile's lse * log2(e) and delta beside it (+inf and
//      0 past seq_len). Per query tile the warpgroup runs S^T = K Q^T and
//      dP^T = V dO^T as wgmma m64n64k16 with both operands K-major in
//      shared memory, forms P^T = exp2(S^T * scale * log2(e) + bias - lse)
//      and dS^T = P^T (dP^T - delta) in the f32 accumulators, rounds them
//      to bf16 straight into the register A fragments of dV += P^T dO and
//      dK += dS^T Q (wgmma m64n{d}k16, A from registers, B = the same dO
//      and Q tiles read MN-major through the transpose flag), and releases
//      the stage. dK and dV stay in f32 registers for the whole loop.
//   3. dQ kernel: a block per (b, h, 64-query tile), Q and dO resident, K
//      and V (and a ring step's key bias) streamed: S = Q K^T, dP = dO V^T,
//      dS with keys past kv_len masked to P = 0, dQ += dS K with K read
//      MN-major.
// The split recomputes S and dP in the dQ kernel (seven N x N x d products
// for the bound's five) so that every sum has one owner and a fixed order:
// two runs give bitwise equal gradients, which the sequence-parallel step
// needs (its ranks' parameters must stay bitwise equal). A single pass with
// dQ summed across key tiles would need atomics or ordered semaphores.
// Tiles: 64 rows of d bf16 as TMA writes them, k-blocks of 64 columns
// swizzled 128B (d = 32: 64-byte rows swizzled 64B, d = 128: two k-blocks),
// each serving K-major and MN-major descriptors (flash_sm90.cuh). Ragged
// tails arrive zero-filled from TMA; nothing is stored past seq_len (dq) or
// kv_len (dk, dv). P and dS are rounded to bf16 before their products, as
// before. A gradient sums over up to 4,097 rows in one f32 accumulator:
// the tolerance's eight bf16 spacings leave that far behind.
// What bounds it now: per 64 x 64 tile the warpgroup's exponentials and
// elementwise work (exp2 of 4,096 scores on the 16-a-clock MUFU pipe, some
// five FP32 operations per score) stand beside its tensor work (four or
// three 64 x 64 x d products), and a warpgroup waits for its own products
// before the elementwise step: the overlap comes from two blocks on an SM
// (one at d = 128, for registers), not from inside one.
//
// Design of the f32 bodies at d = 32 and 64 (compute_dtype float32,
// TrainConfig's default): the same two kernels after the same delta
// pre-pass, all seven products f32-accurate on tf32 wgmma as 3xTF32
// (flash_common.cuh: hi * hi + hi * lo + lo * hi, lo * lo dropped), at a
// third of the 495 TFLOP/s of tf32. tf32 wgmma reads only K-major shared
// operands, and three products need their streamed operand transposed (dV
// += P^T dO needs dO^T, dK += dS^T Q needs Q^T, dQ += dS K needs K^T). So
// a split pre-pass writes tf32 hi and lo copies of Q, K, V and dO, and
// transposed hi and lo copies of Q, dO and K (d rows of tokens), into
// scratch the wrapper allocates (split_layout); TMA loads them as they
// are. The transposed copies hold each 8-token group permuted (position t:
// token 2t, t + 4: token 2t + 1), the order in which an accumulator's
// columns land as a tf32 A fragment, so P^T, dS^T and dS go from the
// S^T / dP^T / S / dP accumulators into register A fragments, split into hi
// and lo in registers, with no shuffle. An f32 tile is twice a bf16 one
// and hi + lo doubles it again, so the streamed tiles are 32 rows (S^T and
// S are m64n32k8 over d, the dK/dV/dQ products m64n{d}k8 over 32 rows);
// the resident 64-row K and V (or Q and dO) stay as hi and lo. A block is
// one consumer warpgroup at d = 64 (two stages of 64 KB beside 64 KB
// resident in the dK/dV kernel, three of 48 KB in the dQ kernel) and two
// at d = 32 (128 rows a block, four stages), one block an SM, and a
// producer warp. The tensor cores' f32 sums truncate: each stage's partial
// dK, dV or dQ goes into a fresh accumulator (12 products) that is added to
// the f32 sum on the FMA pipes; S^T, dP^T, S and dP sum all of d in one.
// What bounds it: each 32-row stage brings 8 (dK/dV) or 6 (dQ) tiles of 32
// x d floats from L2 for 48 x 32 x d tf32 FLOP a key or query row of the
// block, about one byte for 48 FLOP per 64-row warpgroup: at 2,048 tf32
// FLOP a clock and SM that is ~40 bytes a clock, above what L2 gives an
// SM when all 132 pull, so the two warpgroups of a d = 32 block share every
// stage.
//
// Why that layout does not carry over to d = 128 (the opt-in `_fast`
// preset's head dim), and what runs there instead:
//   - Shared memory. A 64-row f32 tile at d = 128 is 32 KiB, and its lo
//     copy another 32 KiB, so the dK/dV kernel's resident K and V (hi and
//     lo) take 128 KiB. Its 32-query stage of eight tiles (Q, dO, Q^T and
//     dO^T, each hi and lo) takes another 128 KiB: 256 KiB is over the
//     232,448 bytes a block may use, so not even one stage fits. The dQ
//     kernel (128 KiB resident, six 16 KiB tiles a 32-key stage) fits
//     exactly one stage, which leaves nothing to overlap.
//   - Registers. One m64n128 f32 accumulator is 64 registers a thread. In
//     one warpgroup the dK/dV kernel would hold two sums (128), a fresh
//     accumulator (64), S^T and dP^T (m64n32: 32) and the hi and lo A
//     fragments of P^T and dS^T (64): about 288, over the 255 a thread may
//     have.
// So at d = 128 the dK/dV kernel splits in two, each owning one sum, after
// the same delta and split pre-passes, and every kernel is one consumer
// warpgroup (64 rows a block) and a producer warp with two stages:
//   kernel  resident            a stage                                 shared   registers  products
//   dV      K hi/lo, 64 KiB     32 queries: Q, dO^T hi/lo, 64 KiB       192 KiB  ~192       S^T, dV
//   dK      K, V hi/lo, 128 KiB 16 queries: Q, dO, Q^T hi/lo, 48 KiB    224 KiB  ~176       S^T, dP^T, dK
//   dQ      Q, dO hi/lo, 128 KiB 16 keys: K, V, K^T hi/lo, 48 KiB       224 KiB  ~176       S, dP, dQ
// (registers: the f32 sum and a fresh accumulator, 64 each, the score
// accumulators at m64n32 or m64n16 and the A fragments of one chunk). That
// is eight 3xTF32 products where the bound counts five and the d = 32 / 64
// bodies run seven: S^T is computed once more, the price of fitting. The
// chunk depth of a fresh accumulator is the stage's: 32 queries for dV, 16
// for dK and dQ (two k8 steps, whose 8-token permutation is the one above).
// Each score product sums its 128 dims in two fresh accumulators of 64,
// added to nearest (`scores_split`): one accumulator over all of d would
// truncate 48 times at scores of 1.4 times d = 64's spread, which the CPU
// witness's emulation reads at 0.6 of `bwd_tolerance`; the halves read
// 0.3, as d = 64 does.
// A 16-token transposed tile is 64-byte rows, swizzled 64B (512-byte atoms),
// read K-major as the d = 32 bf16 tiles are; the 16-row tiles of Q, dO, K
// and V are one 8-row atom pair per 32-column k-block, read as m64n16k8's B.
// What bounds it: tensor work, as above; the dK and dQ kernels' m64n16
// score products read the 64-row A tile from shared memory for 16 columns
// each, which holds them well under the dV kernel's rate per product.

#include "flash_sm90.cuh"

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
  float* split;      // scratch of flash_bwd_split_floats floats (the f32 bodies' tf32 copies), or null
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

// The wgmma probe's tile, n in {32, 64, 128}: bf16, d (64 x n f32) = a (64
// x 64) b (64 x n), a and b contiguous; f32 (tf32), d = a (64 x 32) b^T with
// b contiguous (n x 32), K-major.
struct WgmmaProbeParams {
  const void* a;
  const void* b;
  float* d;
  int n;
  int a_from_registers;
};

namespace {

using namespace flash;

constexpr int kThreads = 128;

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
//
// wgmma bodies: one consumer warpgroup owns a 64-row tile (keys in the
// dK/dV kernel, queries in the dQ kernel) whose operands stay resident in
// shared memory; one producer warp streams the other side's 64-row tiles
// through TMA into a ring of stages behind full/empty mbarriers.


// Tiles: BwdTiling, desc_k, desc_mn and load_rows (flash_sm90.cuh).

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<uint32_t*>(dst) = pack_f32(x, y);
}
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

// Stores rows (16 * warp + g, + 8) of a 64 x D accumulator, times `mul`, as
// pairs of T at columns 8j + 2t; rows at or past `rows` are not stored.
template <int D, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], float mul, T* base, long long row_stride,
                                           int row0, int rows, int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + g + 8 * r;
    if (row >= rows) continue;
    T* dst = base + row * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) store_pair(dst + j * 8, acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

// dK and dV of 64 keys: S^T = K Q^T and dP^T = V dO^T (both operands
// K-major), P^T = exp(S^T * scale + bias - lse) and dS^T = P^T (dP^T -
// delta) in the accumulators, rounded to bf16 as the register A of dV +=
// P^T dO and dK += dS^T Q (dO and Q MN-major), over every 64-query tile.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kWsThreads, BwdTiling<D>::kMinBlocks)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                            const FlashBwdParams p) {
  using T = BwdTiling<D>;
  using namespace sm90;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* ks = base;
  unsigned char* vs = base + T::kTileBytes;
  unsigned char* stream = base + 2 * T::kTileBytes;  // stage s: Q at 2s, dO at 2s + 1 tiles
  float* rows_s = reinterpret_cast<float*>(base + T::kRowsOffset);  // stage s: lse2 [128s, +64), delta [+64, +128)
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const int qtiles = (n + kBlock - 1) / kBlock;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx arrival and the producer lanes' rows
      mbar_init(&empty[s], 1);
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp
    const float* lse_g = p.lse + ((long long)b * p.heads + h) * n;
    const float* delta_g = p.delta + ((long long)b * p.heads + h) * n;
    const uint64_t once = l2_evict_first();
    const uint64_t shared_by_all = l2_evict_last();  // every key tile of the head reads Q and dO
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_q);
      tma_prefetch_descriptor(&tm_do);
      mbar_arrive_expect_tx(kvbar, 2 * T::kTileBytes);
      load_rows<D>(ks, &tm_k, k0, h, b, kvbar, once);
      load_rows<D>(vs, &tm_v, k0, h, b, kvbar, once);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < qtiles; ++qt) {
      mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: every stage starts empty
      const int q0 = qt * kBlock;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes);
        load_rows<D>(stream + 2 * stage * T::kTileBytes, &tm_q, q0, h, b, &full[stage], shared_by_all);
        load_rows<D>(stream + (2 * stage + 1) * T::kTileBytes, &tm_do, q0, h, b, &full[stage], shared_by_all);
      }
      // lse * log2(e) and delta of the tile's rows: +inf and 0 past N, so
      // that P = 0 there
      float* rs = rows_s + stage * 2 * kBlock;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = lane + 32 * i;
        const bool live = q0 + r < n;
        rs[r] = live ? lse_g[q0 + r] * kLog2e : INFINITY;
        rs[kBlock + r] = live ? delta_g[q0 + r] : 0.f;
      }
      mbar_arrive(&full[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  float kb[2] = {0.f, 0.f};  // the bias of this thread's key rows (g, g + 8), log2 units
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + warp * 16 + g + 8 * r;
      kb[r] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
    }
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < qtiles; ++qt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* qs = stream + 2 * stage * T::kTileBytes;
    const unsigned char* dos = qs + T::kTileBytes;
    const float* lse2 = rows_s + stage * 2 * kBlock;
    const float* delta = lse2 + kBlock;
    float st[32], dpt[32];  // S^T and dP^T: 64 keys x 64 queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss<0>(st, desc_k<D>(ks, kk), desc_k<D>(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss<0>(dpt, desc_k<D>(vs, kk), desc_k<D>(dos, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);
    // accumulator element 4j + e: key row g (+ 8 for e >= 2) of the warp,
    // query column 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x;
        const float x = HAS_BIAS ? fmaf(st[4 * j + e], scale2, kb[e >> 1]) - lv : fmaf(st[4 * j + e], scale2, -lv);
        const float pv = ex2(x);
        st[4 * j + e] = pv;
        dpt[4 * j + e] = pv * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a(st, kk, pa[kk]);
      acc_to_a(dpt, kk, da[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(dv, pa[kk], desc_mn<D>(dos, kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(dk, da[kk], desc_mn<D>(qs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
    fence_frags(pa);
    fence_frags(da);
    if (threadIdx.x == 0) mbar_arrive(&empty[stage]);  // the warpgroup's products on the stage are done
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_tile<D>(dk, p.scale, static_cast<__nv_bfloat16*>(p.dk) + bh_offset(p.dk_sb, p.dk_sh, b, h), p.dk_sn, k0,
                nk, warp, g, t);
  store_tile<D>(dv, 1.f, static_cast<__nv_bfloat16*>(p.dv) + bh_offset(p.dv_sb, p.dv_sh, b, h), p.dv_sn, k0, nk,
                warp, g, t);
}

// dQ of 64 queries: S = Q K^T and dP = dO V^T (K-major), dS = P (dP -
// delta) with keys past kv_len masked to P = 0, rounded to bf16 as the
// register A of dQ += dS K (K MN-major), over every 64-key tile.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(kWsThreads, BwdTiling<D>::kMinBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                          const FlashBwdParams p) {
  using T = BwdTiling<D>;
  using namespace sm90;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* dos = base + T::kTileBytes;
  unsigned char* stream = base + 2 * T::kTileBytes;  // stage s: K at 2s, V at 2s + 1 tiles
  float* bias_s = reinterpret_cast<float*>(base + T::kRowsOffset);  // stage s: [128s, +64), log2 units
  uint64_t* full = reinterpret_cast<uint64_t*>(base + T::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const int ktiles = (nk + kBlock - 1) / kBlock;
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
    const uint64_t once = l2_evict_first();
    const uint64_t shared_by_all = l2_evict_last();  // every query tile of the head reads K and V
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_k);
      tma_prefetch_descriptor(&tm_v);
      mbar_arrive_expect_tx(qbar, 2 * T::kTileBytes);
      load_rows<D>(qs, &tm_q, q0, h, b, qbar, once);
      load_rows<D>(dos, &tm_do, q0, h, b, qbar, once);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      const int k0 = kt * kBlock;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes);
        load_rows<D>(stream + 2 * stage * T::kTileBytes, &tm_k, k0, h, b, &full[stage], shared_by_all);
        load_rows<D>(stream + (2 * stage + 1) * T::kTileBytes, &tm_v, k0, h, b, &full[stage], shared_by_all);
      }
      if constexpr (HAS_BIAS) {
        float* bs = bias_s + stage * 2 * kBlock;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = k0 + lane + 32 * i;
          bs[lane + 32 * i] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
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

  const int g = lane >> 2;
  const int t = lane & 3;
  const float scale2 = p.scale * kLog2e;
  float lse2[2], dl[2];  // rows g and g + 8 of the warp: +inf and 0 past N
  {
    const long long bh = ((long long)b * p.heads + h) * n;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + g + 8 * r;
      lse2[r] = row < n ? p.lse[bh + row] * kLog2e : INFINITY;
      dl[r] = row < n ? p.delta[bh + row] : 0.f;
    }
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    const int k0 = kt * kBlock;
    const unsigned char* ks = stream + 2 * stage * T::kTileBytes;
    const unsigned char* vs = ks + T::kTileBytes;
    float s[32], dp[32];  // S and dP: 64 queries x 64 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss<0>(s, desc_k<D>(qs, kk), desc_k<D>(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<64>::ss<0>(dp, desc_k<D>(dos, kk), desc_k<D>(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);
    fence_operands(dp);
    // element 4j + e: query row g (+ 8 for e >= 2), key column 8j + 2t + (e & 1)
    const bool tail = k0 + kBlock > nk;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 bb = make_float2(0.f, 0.f);
      if constexpr (HAS_BIAS) bb = *reinterpret_cast<const float2*>(bias_s + stage * 2 * kBlock + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = HAS_BIAS ? fmaf(s[4 * j + e], scale2, (e & 1) ? bb.y : bb.x) - lse2[e >> 1]
                                 : fmaf(s[4 * j + e], scale2, -lse2[e >> 1]);
        float pv = ex2(x);
        if (tail && k0 + 8 * j + 2 * t + (e & 1) >= nk) pv = 0.f;
        dp[4 * j + e] = pv * (dp[4 * j + e] - dl[e >> 1]);
      }
    }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dp, kk, da[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Wgmma<D>::template rs<1>(dq, da[kk], desc_mn<D>(ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq);
    fence_frags(da);
    if (threadIdx.x == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_tile<D>(dq, p.scale, static_cast<__nv_bfloat16*>(p.dq) + bh_offset(p.dq_sb, p.dq_sh, b, h), p.dq_sn, q0, n,
                warp, g, t);
}

template <int D, bool HAS_BIAS>
cudaError_t launch_bf16(const FlashBwdParams& p, cudaStream_t stream) {
  using T = BwdTiling<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (encode_rows<D>(&tm_q, p.q, p.q_sb, p.q_sn, p.q_sh, p.seq_len, p.heads, p.batch) != CUDA_SUCCESS ||
      encode_rows<D>(&tm_k, p.k, p.k_sb, p.k_sn, p.k_sh, p.kv_len, p.heads, p.batch) != CUDA_SUCCESS ||
      encode_rows<D>(&tm_v, p.v, p.v_sb, p.v_sn, p.v_sh, p.kv_len, p.heads, p.batch) != CUDA_SUCCESS ||
      encode_rows<D>(&tm_do, p.do_, p.do_sb, p.do_sn, p.do_sh, p.seq_len, p.heads, p.batch) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D, HAS_BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, HAS_BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 key_grid((p.kv_len + kBlock - 1) / kBlock, p.heads, p.batch);
  const dim3 query_grid((p.seq_len + kBlock - 1) / kBlock, p.heads, p.batch);
  flash_bwd_dkdv_wgmma_kernel<D, HAS_BIAS><<<key_grid, kWsThreads, T::kSmem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D, HAS_BIAS><<<query_grid, kWsThreads, T::kSmem, stream>>>(tm_q, tm_k, tm_v, tm_do, p);
  return cudaGetLastError();
}

// ------------------------------------------------------ wgmma probe (tests)
//
// One tile through the helpers the bf16 bodies use: d (64 x N f32) = a (64
// x 64 bf16, row-major) b (64 x N bf16, row-major), b loaded by TMA into
// the tile layout above and read MN-major (the transpose flag), a read
// K-major from shared memory (the `ss` form) or from registers (`rs`).
// Held to torch.matmul by the CUDA tests.

template <int N>
__global__ void __launch_bounds__(128) wgmma_probe_kernel(const __grid_constant__ CUtensorMap tm_a,
                                                          const __grid_constant__ CUtensorMap tm_b,
                                                          const WgmmaProbeParams p) {
  using namespace sm90;
  __shared__ __align__(1024) unsigned char tiles[kBlock * 128 + BwdTiling<128>::kTileBytes];
  __shared__ uint64_t bar;
  unsigned char* as = tiles;
  unsigned char* bs = tiles + kBlock * 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint64_t policy = l2_evict_first();
    mbar_arrive_expect_tx(&bar, kBlock * 128 + BwdTiling<N>::kTileBytes);
    tma_load_2d(as, &tm_a, 0, 0, &bar, policy);
#pragma unroll
    for (int kb = 0; kb < BwdTiling<N>::kKBlocks; ++kb) {
      tma_load_2d(bs + kb * BwdTiling<N>::kBoxBytes, &tm_b, kb * BwdTiling<N>::kBoxCols, 0, &bar, policy);
    }
  }
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(p.a);
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // the m16n8k16 A fragment of rows 16 * warp .. + 15
    const __nv_bfloat16* r0 = a + (warp * 16 + g) * 64 + kk * 16 + 2 * t;
    af[kk][0] = ld32(r0);
    af[kk][1] = ld32(r0 + 8 * 64);
    af[kk][2] = ld32(r0 + 8);
    af[kk][3] = ld32(r0 + 8 * 64 + 8);
  }
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (p.a_from_registers) {
      Wgmma<N>::template rs<1>(d, af[kk], desc_mn<N>(bs, kk), 1);
    } else {
      Wgmma<N>::template ss<1>(d, desc_k<64>(as, kk), desc_mn<N>(bs, kk), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(d);
  fence_frags(af);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.d[(warp * 16 + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
    }
  }
}

template <int N>
cudaError_t launch_probe(const WgmmaProbeParams& p, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  if (sm90::encode_bf16_2d(&tm_a, p.a, kBlock, 64, kBlock, 64, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS ||
      sm90::encode_bf16_2d(&tm_b, p.b, kBlock, N, kBlock, BwdTiling<N>::kBoxCols,
                           N == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  wgmma_probe_kernel<N><<<1, 128, 0, stream>>>(tm_a, tm_b, p);
  return cudaGetLastError();
}

// ---------------------------------------------------- f32 path: 3xTF32 wgmma
//
// The f32 bodies (design in the header comment): a split pre-pass, then the
// dK/dV side (one kernel at d = 32 and 64; at d = 128 a dV kernel and a dK
// kernel) and a dQ kernel, each of kCons consumer warpgroups (64 rows each)
// and one producer warp. Their tiles, descriptors, loads and products are
// flash_sm90.cuh's 3xTF32 building blocks, which the f32 forward shares.

template <int D>
struct Tf32Bwd {
  static constexpr int kResBytes = kBlock * D * 4;   // a resident 64-row tile, hi or lo
  static constexpr int kCons = D == 32 ? 2 : 1;      // consumer warpgroups: a block owns 64 * kCons keys or queries
  static constexpr int kThreads = kCons * 128 + 32;  // and a producer warp
};

// The ring of a dK/dV-side kernel that owns the dK sums (DK), the dV sums
// (DV) or both: [kCons x (K hi, K lo; with DK V hi, V lo)][kStages x (Q hi,
// Q lo; with DK dO hi, dO lo, Q^T hi, Q^T lo; with DV dO^T hi, dO^T lo)]
// [kStages x 2 x kRows f32: lse2 and delta of the stage's rows][barriers]
template <int D, bool DK, bool DV>
struct Tf32KvRing {
  static constexpr int kRows = D == 128 && DK ? 16 : 32;  // queries a stage: the depth of a dK or dV chunk
  static constexpr int kStages = D == 32 ? 4 : 2;
  static constexpr int kRowBytes = kRows * D * 4;  // a streamed tile, or a transposed one (D rows of kRows tokens)
  static constexpr int kResTiles = DK ? 4 : 2;
  static constexpr int kStageTiles = 2 + (DK ? 4 : 0) + (DV ? 2 : 0);
  static constexpr int kDot = DK ? 6 : 2;  // the stage's dO^T hi tile
  static constexpr int kRowsOffset =
      Tf32Bwd<D>::kCons * kResTiles * Tf32Bwd<D>::kResBytes + kStages * kStageTiles * kRowBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * 2 * kRows * 4;
  static constexpr int kSmem = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// The dQ kernel's ring: [kCons x (Q hi, Q lo, dO hi, dO lo)][kStages x (K
// hi, K lo, V hi, V lo, K^T hi, K^T lo)][kStages x kRows f32: the stage's
// key bias][barriers]
template <int D>
struct Tf32QRing {
  static constexpr int kRows = D == 128 ? 16 : 32;  // keys a stage: the depth of a dQ chunk
  static constexpr int kStages = D == 32 ? 4 : (D == 64 ? 3 : 2);
  static constexpr int kRowBytes = kRows * D * 4;
  static constexpr int kRowsOffset = Tf32Bwd<D>::kCons * 4 * Tf32Bwd<D>::kResBytes + kStages * 6 * kRowBytes;
  static constexpr int kBarOffset = kRowsOffset + kStages * kRows * 4;
  static constexpr int kSmem = 1024 + kBarOffset + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// The head dims whose f32 backward runs these bodies: all that `flash_bwd`
// takes.
constexpr bool tf32_body(int d) { return d == 32 || d == 64 || d == 128; }

// The pre-pass's copies, float offsets into the wrapper's scratch
// (flash_bwd_split_floats sizes it), each hi at [0] and lo at [1] of its
// outer axis: qs, dos (2, BH, seq_len, D) and ks, vs (2, BH, kv_len, D)
// row-major; qt, dot (2, BH, D, npq) and kt (2, BH, D, npk), transposed,
// the token axis padded to a multiple of 8 (zeros) and permuted within
// each 8-token group by tf32_token.
struct SplitLayout {
  long long qs, dos, ks, vs, qt, dot, kt, end;
  long long bh, npq, npk;
};

__host__ __device__ inline SplitLayout split_layout(const FlashBwdParams& p) {
  SplitLayout s;
  s.bh = (long long)p.batch * p.heads;
  s.npq = pad8(p.seq_len);
  s.npk = pad8(p.kv_len);
  const long long rows_q = 2 * s.bh * p.seq_len * p.head_dim, rows_k = 2 * s.bh * p.kv_len * p.head_dim;
  s.qs = 0;
  s.dos = s.qs + rows_q;
  s.ks = s.dos + rows_q;
  s.vs = s.ks + rows_k;
  s.qt = s.vs + rows_k;
  s.dot = s.qt + 2 * s.bh * p.head_dim * s.npq;
  s.kt = s.dot + 2 * s.bh * p.head_dim * s.npq;
  s.end = s.kt + 2 * s.bh * p.head_dim * s.npk;
  return s;
}

// One (b, h, 32-token tile) a block: Q, dO, K and V rows split into tf32
// hi and lo (cvt.rna), and the transposed copies of Q, dO and K through a
// shared-memory tile; reads along d and transposed writes along the token
// axis coalesced.
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_split_kernel(const FlashBwdParams p) {
  __shared__ float tile[kTfRows][D + 1];
  const SplitLayout s = split_layout(p);
  const int t0 = blockIdx.x * kTfRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long bh = (long long)b * p.heads + h;
#pragma unroll 1
  for (int op = 0; op < 4; ++op) {  // Q, dO, K, V
    const float* src = static_cast<const float*>(op == 0 ? p.q : op == 1 ? p.do_ : op == 2 ? p.k : p.v);
    const long long sb = op == 0 ? p.q_sb : op == 1 ? p.do_sb : op == 2 ? p.k_sb : p.v_sb;
    const long long sn = op == 0 ? p.q_sn : op == 1 ? p.do_sn : op == 2 ? p.k_sn : p.v_sn;
    const long long sh = op == 0 ? p.q_sh : op == 1 ? p.do_sh : op == 2 ? p.k_sh : p.v_sh;
    const int rows = op < 2 ? p.seq_len : p.kv_len;
    const long long np = op < 2 ? s.npq : s.npk;
    float* dst = p.split + (op == 0 ? s.qs : op == 1 ? s.dos : op == 2 ? s.ks : s.vs);
    float* tdst = op == 3 ? nullptr : p.split + (op == 0 ? s.qt : op == 1 ? s.dot : s.kt);
    if (t0 >= np) continue;  // the whole block
    __syncthreads();  // the last operand's transposed reads are done
    for (int i = threadIdx.x; i < kTfRows * D; i += 256) {
      const int r = i / D;
      const int c = i % D;
      const int row = t0 + r;
      const float x = row < rows ? src[b * sb + h * sh + row * sn + c] : 0.f;
      tile[r][c] = x;
      if (row < rows) {
        const Tf32x2 v = split_tf32(x);
        dst[(bh * rows + row) * D + c] = __uint_as_float(v.hi);
        dst[((s.bh + bh) * rows + row) * D + c] = __uint_as_float(v.lo);
      }
    }
    if (tdst == nullptr) continue;
    __syncthreads();
    for (int i = threadIdx.x; i < kTfRows * D; i += 256) {
      const int c = i / kTfRows;
      const int pos = i % kTfRows;
      if (t0 + pos >= np) continue;
      const Tf32x2 v = split_tf32(tile[(pos & ~7) + tf32_token(pos & 7)][c]);
      tdst[(bh * D + c) * np + t0 + pos] = __uint_as_float(v.hi);
      tdst[((s.bh + bh) * D + c) * np + t0 + pos] = __uint_as_float(v.lo);
    }
  }
}

// dK (DK) and dV (DV) of 64 * kCons keys, warpgroup w owning keys 64w ..
// 64w + 63 of the block: per stage of kRows queries S^T = K Q^T (and with
// DK dP^T = V dO^T; n = kRows, over D), P^T (and dS^T) in the
// accumulators, split into tf32 A fragments, dV += P^T dO (B = dO^T) and
// dK += dS^T Q (B = Q^T; n = D, over the stage's queries, B the permuted
// transposed copies) into fresh accumulators added to the f32 sums.
template <int D, bool HAS_BIAS, bool DK, bool DV>
__global__ void __launch_bounds__(Tf32Bwd<D>::kThreads, 1)
flash_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_qt, const __grid_constant__ CUtensorMap tm_dot,
                           const FlashBwdParams p) {
  using T = Tf32Bwd<D>;
  using S = Tf32KvRing<D, DK, DV>;
  using namespace sm90;
  constexpr int kStages = S::kStages;
  constexpr int kRows = S::kRows;
  constexpr int kRes = T::kResBytes;
  constexpr int kRow = S::kRowBytes;
  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* stream = base + T::kCons * S::kResTiles * kRes;  // stage s: its tiles from stream + kStageTiles s kRow
  float* rows_s = reinterpret_cast<float*>(base + S::kRowsOffset);  // stage s: lse2 [2 kRows s, +kRows), delta after
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* kvbar = empty + kStages;

  const int k0 = blockIdx.x * kBlock * T::kCons;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int n = p.seq_len;
  const int nk = p.kv_len;
  const int qtiles = (n + kRows - 1) / kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA's expect_tx arrival and the producer lanes' rows
      mbar_init(&empty[s], T::kCons);
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * T::kCons) {  // the producer warp
    const float* lse_g = p.lse + (long long)bh * n;
    const float* delta_g = p.delta + (long long)bh * n;
    const uint64_t once = l2_evict_first();
    const uint64_t shared_by_all = l2_evict_last();  // every key block of the head reads the query side
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_q);
      if constexpr (DK) {
        tma_prefetch_descriptor(&tm_do);
        tma_prefetch_descriptor(&tm_qt);
      }
      if constexpr (DV) tma_prefetch_descriptor(&tm_dot);
      mbar_arrive_expect_tx(kvbar, T::kCons * S::kResTiles * kRes);
      for (int w = 0; w < T::kCons; ++w) {
        for (int hl = 0; hl < 2; ++hl) {
          unsigned char* res = base + S::kResTiles * w * kRes;
          load_split_rows<D, kBlock>(res + hl * kRes, &tm_k, k0 + kBlock * w, bh, hl, kvbar, once);
          if constexpr (DK) {
            load_split_rows<D, kBlock>(res + (2 + hl) * kRes, &tm_v, k0 + kBlock * w, bh, hl, kvbar, once);
          }
        }
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < qtiles; ++qt) {
      mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: every stage starts empty
      const int q0 = qt * kRows;
      unsigned char* st = stream + S::kStageTiles * stage * kRow;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], S::kStageTiles * kRow);
        for (int hl = 0; hl < 2; ++hl) {
          load_split_rows<D, kRows>(st + hl * kRow, &tm_q, q0, bh, hl, &full[stage], shared_by_all);
          if constexpr (DK) {
            load_split_rows<D, kRows>(st + (2 + hl) * kRow, &tm_do, q0, bh, hl, &full[stage], shared_by_all);
            tma_load_4d(st + (4 + hl) * kRow, &tm_qt, q0, 0, bh, hl, &full[stage], shared_by_all);
          }
          if constexpr (DV) {
            tma_load_4d(st + (S::kDot + hl) * kRow, &tm_dot, q0, 0, bh, hl, &full[stage], shared_by_all);
          }
        }
      }
      // lse * log2(e) and delta of the stage's rows: +inf and 0 past N, so
      // that P = 0 there
      if (lane < kRows) {
        float* rs = rows_s + stage * 2 * kRows;
        const bool live = q0 + lane < n;
        rs[lane] = live ? lse_g[q0 + lane] * kLog2e : INFINITY;
        rs[kRows + lane] = live ? delta_g[q0 + lane] : 0.f;
      }
      mbar_arrive(&full[stage]);
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
  const unsigned char* k_hi = base + S::kResTiles * wg * kRes;  // then K lo (and V hi, V lo)
  const int key0 = k0 + kBlock * wg;
  const float scale2 = p.scale * kLog2e;
  float kb[2] = {0.f, 0.f};  // the bias of this thread's key rows (g, g + 8), log2 units
  if constexpr (HAS_BIAS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + wl * 16 + g + 8 * r;
      kb[r] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
    }
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kvbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < qtiles; ++qt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = stream + S::kStageTiles * stage * kRow;
    const float* lse2 = rows_s + stage * 2 * kRows;
    const float* delta = lse2 + kRows;
    float s[kRows / 2], dp[kRows / 2], s2[kRows / 2], dp2[kRows / 2];  // S^T and dP^T: 64 keys x kRows queries
    wgmma_fence();
    scores_split<D, kRows>(s, s2, k_hi, k_hi + kRes, st, st + kRow);
    if constexpr (DK) scores_split<D, kRows>(dp, dp2, k_hi + 2 * kRes, k_hi + 3 * kRes, st + 2 * kRow, st + 3 * kRow);
    wgmma_commit();
    wgmma_wait<0>();
    scores_join<D, kRows>(s, s2);
    if constexpr (DK) scores_join<D, kRows>(dp, dp2);
    // accumulator element 4j + e: key row g (+ 8 for e >= 2) of the warp,
    // query column 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lv = (e & 1) ? l2.y : l2.x;
        const float x = HAS_BIAS ? fmaf(s[4 * j + e], scale2, kb[e >> 1]) - lv : fmaf(s[4 * j + e], scale2, -lv);
        const float pv = ex2(x);
        s[4 * j + e] = pv;
        if constexpr (DK) dp[4 * j + e] = pv * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
    }
    uint32_t pa_hi[kRows / 8][4], pa_lo[kRows / 8][4], da_hi[kRows / 8][4], da_lo[kRows / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) {
      if constexpr (DV) acc_to_tf32_a(s, kk, pa_hi[kk], pa_lo[kk]);
      if constexpr (DK) acc_to_tf32_a(dp, kk, da_hi[kk], da_lo[kk]);
    }
    float dv_chunk[D / 2], dk_chunk[D / 2];
    wgmma_fence();
    const unsigned char* dot_hi = st + S::kDot * kRow;
    if constexpr (DV) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);  // P^T dO, B = dO^T
    if constexpr (DK) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS^T Q, B = Q^T
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (DV) {
      fence_operands(dv_chunk);
      fence_frags(pa_hi);
      fence_frags(pa_lo);
    }
    if constexpr (DK) {
      fence_operands(dk_chunk);
      fence_frags(da_hi);
      fence_frags(da_lo);
    }
    if (lead) mbar_arrive(&empty[stage]);  // the warpgroup's products on the stage are done
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      if constexpr (DV) dv[i] += dv_chunk[i];
      if constexpr (DK) dk[i] += dk_chunk[i];
    }
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if constexpr (DK) {
    store_tile<D>(dk, p.scale, static_cast<float*>(p.dk) + bh_offset(p.dk_sb, p.dk_sh, b, h), p.dk_sn, key0, nk, wl,
                  g, t);
  }
  if constexpr (DV) {
    store_tile<D>(dv, 1.f, static_cast<float*>(p.dv) + bh_offset(p.dv_sb, p.dv_sh, b, h), p.dv_sn, key0, nk, wl, g,
                  t);
  }
}

// dQ of 64 * kCons queries, warpgroup w owning queries 64w .. 64w + 63:
// per stage of kRows keys S = Q K^T and dP = dO V^T (n = kRows, over D),
// dS = P (dP - delta) with keys past kv_len masked to P = 0, split into
// tf32 A fragments, dQ += dS K (n = D, B the permuted K^T) into a fresh
// accumulator added to the f32 sum.
template <int D, bool HAS_BIAS>
__global__ void __launch_bounds__(Tf32Bwd<D>::kThreads, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_kt, const FlashBwdParams p) {
  using T = Tf32Bwd<D>;
  using S = Tf32QRing<D>;
  using namespace sm90;
  constexpr int kStages = S::kStages;
  constexpr int kRows = S::kRows;
  constexpr int kRes = T::kResBytes;
  constexpr int kRow = S::kRowBytes;
  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* stream = base + T::kCons * 4 * kRes;  // stage s: its six tiles from stream + 6s kRow
  float* bias_s = reinterpret_cast<float*>(base + S::kRowsOffset);  // stage s: [kRows s, +kRows), log2 units
  uint64_t* full = reinterpret_cast<uint64_t*>(base + S::kBarOffset);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * kBlock * T::kCons;
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
      mbar_init(&empty[s], T::kCons);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * T::kCons) {  // the producer warp
    const uint64_t once = l2_evict_first();
    const uint64_t shared_by_all = l2_evict_last();  // every query block of the head reads the key side
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_k);
      tma_prefetch_descriptor(&tm_v);
      tma_prefetch_descriptor(&tm_kt);
      mbar_arrive_expect_tx(qbar, T::kCons * 4 * kRes);
      for (int w = 0; w < T::kCons; ++w) {
        for (int hl = 0; hl < 2; ++hl) {
          load_split_rows<D, kBlock>(base + (4 * w + hl) * kRes, &tm_q, q0 + kBlock * w, bh, hl, qbar, once);
          load_split_rows<D, kBlock>(base + (4 * w + 2 + hl) * kRes, &tm_do, q0 + kBlock * w, bh, hl, qbar, once);
        }
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&empty[stage], phase ^ 1);
      const int k0 = kt * kRows;
      unsigned char* st = stream + 6 * stage * kRow;
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[stage], 6 * kRow);
        for (int hl = 0; hl < 2; ++hl) {
          load_split_rows<D, kRows>(st + hl * kRow, &tm_k, k0, bh, hl, &full[stage], shared_by_all);
          load_split_rows<D, kRows>(st + (2 + hl) * kRow, &tm_v, k0, bh, hl, &full[stage], shared_by_all);
          tma_load_4d(st + (4 + hl) * kRow, &tm_kt, k0, 0, bh, hl, &full[stage], shared_by_all);
        }
      }
      if constexpr (HAS_BIAS) {
        const int key = k0 + lane;
        if (lane < kRows) bias_s[stage * kRows + lane] = key < nk ? p.key_bias[key] * kLog2e : 0.f;
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
  const unsigned char* q_hi = base + 4 * wg * kRes;  // then Q lo, dO hi, dO lo
  const int row0 = q0 + kBlock * wg;
  const float scale2 = p.scale * kLog2e;
  float lse2[2], dl[2];  // rows g and g + 8 of the warp: +inf and 0 past N
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wl * 16 + g + 8 * r;
    lse2[r] = row < n ? p.lse[(long long)bh * n + row] * kLog2e : INFINITY;
    dl[r] = row < n ? p.delta[(long long)bh * n + row] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(qbar, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    mbar_wait(&full[stage], phase);
    const int k0 = kt * kRows;
    const unsigned char* st = stream + 6 * stage * kRow;
    float s[kRows / 2], dp[kRows / 2], s2[kRows / 2], dp2[kRows / 2];  // S and dP: 64 queries x kRows keys
    wgmma_fence();
    scores_split<D, kRows>(s, s2, q_hi, q_hi + kRes, st, st + kRow);
    scores_split<D, kRows>(dp, dp2, q_hi + 2 * kRes, q_hi + 3 * kRes, st + 2 * kRow, st + 3 * kRow);
    wgmma_commit();
    wgmma_wait<0>();
    scores_join<D, kRows>(s, s2);
    scores_join<D, kRows>(dp, dp2);
    // element 4j + e: query row g (+ 8 for e >= 2), key column 8j + 2t + (e & 1)
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      float2 bb = make_float2(0.f, 0.f);
      if constexpr (HAS_BIAS) bb = *reinterpret_cast<const float2*>(bias_s + stage * kRows + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = HAS_BIAS ? fmaf(s[4 * j + e], scale2, (e & 1) ? bb.y : bb.x) - lse2[e >> 1]
                                 : fmaf(s[4 * j + e], scale2, -lse2[e >> 1]);
        const float pv = k0 + 8 * j + 2 * t + (e & 1) < nk ? ex2(x) : 0.f;
        dp[4 * j + e] = pv * (dp[4 * j + e] - dl[e >> 1]);
      }
    }
    uint32_t da_hi[kRows / 8][4], da_lo[kRows / 8][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 8; ++kk) acc_to_tf32_a(dp, kk, da_hi[kk], da_lo[kk]);
    float dq_chunk[D / 2];
    wgmma_fence();
    chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS K, B = K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dq_chunk);
    fence_frags(da_hi);
    fence_frags(da_lo);
    if (lead) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] += dq_chunk[i];
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_tile<D>(dq, p.scale, static_cast<float*>(p.dq) + bh_offset(p.dq_sb, p.dq_sh, b, h), p.dq_sn, row0, n, wl, g,
                t);
}

// The dK/dV-side kernel that owns dK (DK) and dV (DV), over the resident
// K and V maps, with its own maps of the streamed query side.
template <int D, bool HAS_BIAS, bool DK, bool DV>
cudaError_t launch_kv_tf32(const FlashBwdParams& p, const SplitLayout& s, const CUtensorMap& k_res,
                           const CUtensorMap& v_res, cudaStream_t stream) {
  using T = Tf32Bwd<D>;
  using S = Tf32KvRing<D, DK, DV>;
  CUtensorMap q_str, do_str, qt, dot;
  if (encode_split(&q_str, p.split + s.qs, s.bh, p.seq_len, D, S::kRows) != CUDA_SUCCESS ||
      encode_split(&do_str, p.split + s.dos, s.bh, p.seq_len, D, S::kRows) != CUDA_SUCCESS ||
      encode_split(&qt, p.split + s.qt, s.bh, D, s.npq, D, S::kRows) != CUDA_SUCCESS ||
      encode_split(&dot, p.split + s.dot, s.bh, D, s.npq, D, S::kRows) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<D, HAS_BIAS, DK, DV>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  constexpr int kRowsABlock = kBlock * T::kCons;
  const dim3 key_grid((p.kv_len + kRowsABlock - 1) / kRowsABlock, p.heads, p.batch);
  flash_bwd_dkdv_tf32_kernel<D, HAS_BIAS, DK, DV><<<key_grid, T::kThreads, S::kSmem, stream>>>(q_str, do_str, k_res,
                                                                                            v_res, qt, dot, p);
  return cudaGetLastError();
}

template <int D, bool HAS_BIAS>
cudaError_t launch_tf32(const FlashBwdParams& p, cudaStream_t stream) {
  using T = Tf32Bwd<D>;
  using Q = Tf32QRing<D>;
  const SplitLayout s = split_layout(p);
  const int longest = p.seq_len > p.kv_len ? p.seq_len : p.kv_len;
  flash_bwd_split_kernel<D><<<dim3((longest + kTfRows - 1) / kTfRows, p.heads, p.batch), 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap q_res, do_res, k_res, v_res, k_str, v_str, kt;
  if (encode_split(&q_res, p.split + s.qs, s.bh, p.seq_len, D, kBlock) != CUDA_SUCCESS ||
      encode_split(&do_res, p.split + s.dos, s.bh, p.seq_len, D, kBlock) != CUDA_SUCCESS ||
      encode_split(&k_res, p.split + s.ks, s.bh, p.kv_len, D, kBlock) != CUDA_SUCCESS ||
      encode_split(&v_res, p.split + s.vs, s.bh, p.kv_len, D, kBlock) != CUDA_SUCCESS ||
      encode_split(&k_str, p.split + s.ks, s.bh, p.kv_len, D, Q::kRows) != CUDA_SUCCESS ||
      encode_split(&v_str, p.split + s.vs, s.bh, p.kv_len, D, Q::kRows) != CUDA_SUCCESS ||
      encode_split(&kt, p.split + s.kt, s.bh, D, s.npk, D, Q::kRows) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  if constexpr (D == 128) {  // a dV kernel, then a dK kernel (the header comment says why)
    err = launch_kv_tf32<D, HAS_BIAS, false, true>(p, s, k_res, v_res, stream);
    if (err != cudaSuccess) return err;
    err = launch_kv_tf32<D, HAS_BIAS, true, false>(p, s, k_res, v_res, stream);
  } else {
    err = launch_kv_tf32<D, HAS_BIAS, true, true>(p, s, k_res, v_res, stream);
  }
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<D, HAS_BIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Q::kSmem);
  if (err != cudaSuccess) return err;
  constexpr int kRowsABlock = kBlock * T::kCons;
  const dim3 query_grid((p.seq_len + kRowsABlock - 1) / kRowsABlock, p.heads, p.batch);
  flash_bwd_dq_tf32_kernel<D, HAS_BIAS><<<query_grid, T::kThreads, Q::kSmem, stream>>>(q_res, do_res, k_str, v_str,
                                                                                     kt, p);
  return cudaGetLastError();
}

// ------------------------------------------------- tf32 wgmma probe (tests)
//
// One tile through the tf32 helpers the f32 bodies use: d (64 x N) = a
// (64 x 32) b^T, a and b (N x 32) loaded by TMA (128-byte rows, swizzled
// 128B), both K-major; a read from shared memory (`ss`) or from registers
// (`rs`, the tf32 bits of each element). Held to torch.matmul in f64 by the
// CUDA tests.

template <int N>
__global__ void __launch_bounds__(128) wgmma_probe_tf32_kernel(const __grid_constant__ CUtensorMap tm_a,
                                                               const __grid_constant__ CUtensorMap tm_b,
                                                               const WgmmaProbeParams p) {
  using namespace sm90;
  __shared__ __align__(1024) unsigned char tiles[kBlock * 128 + N * 128];
  __shared__ uint64_t bar;
  unsigned char* as = tiles;
  unsigned char* bs = tiles + kBlock * 128;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint64_t policy = l2_evict_first();
    mbar_arrive_expect_tx(&bar, kBlock * 128 + N * 128);
    tma_load_2d(as, &tm_a, 0, 0, &bar, policy);
    tma_load_2d(bs, &tm_b, 0, 0, &bar, policy);
  }
  mbar_wait(&bar, 0);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const float* a = static_cast<const float*>(p.a);
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // the m16n8k8 tf32 A fragment of rows 16 * warp .. + 15
    const float* r0 = a + (warp * 16 + g) * 32 + kk * 8 + t;
    af[kk][0] = to_tf32(r0[0]);
    af[kk][1] = to_tf32(r0[8 * 32]);
    af[kk][2] = to_tf32(r0[4]);
    af[kk][3] = to_tf32(r0[8 * 32 + 4]);
  }
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (p.a_from_registers) {
      WgmmaTf32<N>::rs(d, af[kk], desc_tf32<N>(bs, kk), 1);
    } else {
      WgmmaTf32<N>::ss(d, desc_tf32<kBlock>(as, kk), desc_tf32<N>(bs, kk), 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(d);
  fence_frags(af);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p.d[(warp * 16 + g + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
    }
  }
}

template <int N>
cudaError_t launch_probe_tf32(const WgmmaProbeParams& p, cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  if (sm90::encode_f32_2d(&tm_a, p.a, kBlock, 32, kBlock, 32, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS ||
      sm90::encode_f32_2d(&tm_b, p.b, N, 32, N, 32, CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  wgmma_probe_tf32_kernel<N><<<1, 128, 0, stream>>>(tm_a, tm_b, p);
  return cudaGetLastError();
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
  if (is_bf16) return launch_bf16<D, HAS_BIAS>(p, stream);
  return launch_tf32<D, HAS_BIAS>(p, stream);
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

// Floats of the scratch `flash_bwd` reads from p->split for this call: the
// f32 bodies' tf32 copies (split_layout), none in bf16.
long long flash_bwd_split_floats(const FlashBwdParams* p, int is_bf16) {
  return is_bf16 || !tf32_body(p->head_dim) ? 0 : split_layout(*p).end;
}

// One tile of the wgmma probe (WgmmaProbeParams): bf16, or tf32 for f32.
int wgmma_probe(const WgmmaProbeParams* p, int is_bf16, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p->n) {
    case 32: return static_cast<int>(is_bf16 ? launch_probe<32>(*p, s) : launch_probe_tf32<32>(*p, s));
    case 64: return static_cast<int>(is_bf16 ? launch_probe<64>(*p, s) : launch_probe_tf32<64>(*p, s));
    case 128: return static_cast<int>(is_bf16 ? launch_probe<128>(*p, s) : launch_probe_tf32<128>(*p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
