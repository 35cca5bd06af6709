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
// Forward, bf16 (redesigned for Hopper's wgmma and TMA): a block owns a
// slab of 128 rows (64 at C = 1024), two consumer warpgroups of 64 rows
// each plus one producer warp. The producer first loads the slab's raw x
// through TMA, in k-blocks of 64 columns swizzled 128B (the layout wgmma
// reads A in; rows past R arrive as zeros), then keeps a ring of W stages
// of 128 output features in flight through TMA and full/empty mbarriers:
// 64 deep (16 KB, swizzled 128B), 6 to 8 of them, where three fit beside
// the slab; at C = 768, where the slab takes 192 KB, 4 stages 32 deep (8
// KB, swizzled 64B). Each consumer warpgroup normalises its 64 rows once,
// in place in shared memory (the row passes of csrc/ln_rows.cuh; mu and
// rstd written once, by the slab's first run), makes the stores visible to
// the async proxy, then walks its run of 128-column tiles: wgmma
// m64n128k16 bf16 -> f32 with A the resident normalised rows and B the W
// stage, one stage's products in flight while the previous stage is
// released. The normalised rows never reach device memory. Every slab
// streams all of W from L2 once per run, 128 rows per W stage: L2 keeps W
// (evict_last) against the x and y streams (evict_first).
// The epilogue rounds the f32 sum to bf16, then adds the bf16 bias
// (round_then_bias, the bias loaded before the tile's products), transposes
// the words within each quad so that a lane stores 16 contiguous bytes
// (4-byte stores scattered over 8 rows took more than half the kernel's
// time), and masks rows past R and columns past F (TMA zero-fills W rows
// past F). The (slab, run) grid splits F into runs so that the items fill
// the card's SMs with the least waves (`tiles_per_run`), the LayerNorm
// recomputed once per run.
// What holds it back at C = 768: with the slab in 192 KB, only four 8 KB
// W stages fit, and each stage's round trip (release, TMA, landing) is
// paid every 32 deep; at C = 512 the 16 KB stages run it past the library.
//
// Backward, bf16 (redesigned for Hopper's wgmma and TMA), two launches on
// one stream. The dln product dln = dY W: a persistent block per SM walks
// 128 x 128 tiles of (R, C), two consumer warpgroups of 64 rows and one
// producer warp; the producer streams F in 64-deep stages of dY (TMA,
// K-major, evict_first) and W (TMA, 64 rows of W's (F, C) layout: F is
// the depth, so B is MN-major, read through wgmma's transpose flag;
// evict_last) in a ring of six 32 KB stages that runs on across the block's
// tiles; each stage feeds four m64n128k16 per warpgroup, the previous stage
// released while the current one runs. The f32 tile leaves in 16-byte
// streaming stores (lanes t and t ^ 1 swap one pair of each two 8-column
// blocks). Then the row pass that the LayerNorm backward also runs
// (csrc/ln_rows.cuh) reads dln in f32 and writes dx. Both dx and dln leave
// the kernels: dgamma and dbeta are computed outside from dln, as in JAX.
// Fusing the row pass into the product's epilogue would need a tile that
// spans all of C (a 64-row x 768 f32 tile is 192 KB of registers across a
// warpgroup), so it stays a second launch.
// What holds the product back: each 32 KB stage is 2 MFLOP for the two
// warpgroups, about 64 operations a byte of L2 traffic; at C = 768 the 330
// (R6928) tiles fill 132 SMs in 2.5 rounds.
//
// f32 (compute_dtype float32, TrainConfig's default), redesigned for
// Hopper: the forward's product and the dln product run on one 3xTF32
// wgmma + TMA kernel (vitae_lnd_tf32_kernel, described at its section
// below): A from registers, normalised there in the forward, W split into
// tf32 hi and lo copies by a pre-pass, a fresh accumulator for every
// 32-deep chunk. The forward's statistics come from a row pass before it;
// the backward's row pass follows the dln product as in bf16.

#include "ln_rows.cuh"
#include "sm90_common.cuh"

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
  float* w_hi;         // f32 only: W split for the product, (F, C) forward, (C, F) backward
  float* w_lo;
  long long rows;
  int cols;
  int features;
  float eps;
};

namespace {

using namespace flash;
using namespace lnrows;

// The TPU kernel's epilogue order: the f32 sum rounded to bf16, then the
// bf16 bias added and the result rounded again (fused_ln_dense.py:76-77).
__device__ __forceinline__ float round_then_bias(float acc, float bias) {
  return __bfloat162float(__float2bfloat16(acc)) + bias;
}

// ------------------------------------------------------------ bf16 forward

constexpr int kBN = 128;    // output columns per tile: one wgmma N
constexpr int kAtomK = 64;  // columns of an x k-block: 128 bytes a row, swizzled 128B

template <int C>
struct FwdTiling {
  static constexpr int kRows = C <= 768 ? 128 : 64;        // slab rows
  static constexpr int kConsumers = kRows / 64;            // warpgroups of 64 rows
  static constexpr int kThreads = kConsumers * 128 + 32;   // and one producer warp
  static constexpr int kABytes = kRows * C * 2;
  // W stages 64 deep (128-byte rows, swizzled 128B) where at least three
  // fit beside the slab, else 32 deep (64-byte rows, swizzled 64B): C = 768
  static constexpr int kRoom = 224 * 1024 - kABytes;
  static constexpr int kStageK = kRoom / (kBN * 64 * 2) >= 3 ? 64 : 32;
  static constexpr int kStageBytes = kBN * kStageK * 2;
  static constexpr int kStages = kRoom / kStageBytes < 8 ? kRoom / kStageBytes : 8;
  static constexpr int kSwizzle = kStageK == 64 ? sm90::kSwizzle128 : sm90::kSwizzle64;
  static constexpr uint32_t kAtomBytes = kStageK * 2 * 8;  // 8 rows of the stage: the descriptor's SBO
  static constexpr int kSmem = 1024 + kABytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
  static_assert(kStages >= 3, "a W ring of at least three stages");
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

// 4 x 4 transpose of 32-bit words across the four lanes of a quad (t = lane
// % 4): afterwards lane t holds word t of each lane's v. Two exchanges, one
// per bit of t, with selects instead of indexing by t.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1;
  uint32_t x0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
  uint32_t x1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
  if (odd) {
    v[0] = x0;
    v[2] = x1;
  } else {
    v[1] = x0;
    v[3] = x1;
  }
  const bool hi = t & 2;
  x0 = __shfl_xor_sync(0xffffffffu, hi ? v[0] : v[2], 2);
  x1 = __shfl_xor_sync(0xffffffffu, hi ? v[1] : v[3], 2);
  if (hi) {
    v[0] = x0;
    v[1] = x1;
  } else {
    v[2] = x0;
    v[3] = x1;
  }
}

template <int C>
__global__ void __launch_bounds__(FwdTiling<C>::kThreads, 1)
vitae_lnd_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                          const LndParams p, int tiles_per_run) {
  using bf16 = __nv_bfloat16;
  using Tiling = FwdTiling<C>;
  using namespace sm90;
  constexpr int kRows = Tiling::kRows;
  constexpr int kStages = Tiling::kStages;
  constexpr int kStageK = Tiling::kStageK;
  constexpr int kStageBytes = Tiling::kStageBytes;
  constexpr int kKSteps = C / kStageK;
  extern __shared__ unsigned char lnd_smem[];
  // operand tiles start on 1,024-byte boundaries (the swizzle atoms)
  unsigned char* base = lnd_smem + ((1024 - (smem_u32(lnd_smem) & 1023)) & 1023);
  bf16* a = reinterpret_cast<bf16*>(base);  // C / 64 k-blocks of kRows x 64
  unsigned char* ws = base + Tiling::kABytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* xbar = empty + kStages;

  const int ntiles = (p.features + kBN - 1) / kBN;
  const int tile0 = blockIdx.x * tiles_per_run;
  const int tile1 = min(ntiles, tile0 + tiles_per_run);
  const long long row0 = (long long)blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], Tiling::kConsumers);  // one arrival per consumer warpgroup
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == Tiling::kConsumers * 4) {  // the producer warp: TMA only
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_x);
      tma_prefetch_descriptor(&tm_w);
      // x is read once per run, W by every block: W is kept in L2 against
      // the stream of x reads and y writes
      const uint64_t once = l2_evict_first();
      const uint64_t shared_by_all = l2_evict_last();
      mbar_arrive_expect_tx(xbar, Tiling::kABytes);
      for (int kb = 0; kb < C / kAtomK; ++kb) {
        tma_load_2d(a + kb * kRows * kAtomK, &tm_x, kb * kAtomK, static_cast<int>(row0), xbar, once);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = tile0; tile < tile1; ++tile) {
        for (int ks = 0; ks < kKSteps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: every stage starts empty
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(ws + stage * kStageBytes, &tm_w, ks * kStageK, tile * kBN, &full[stage], shared_by_all);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: slab rows wg*64 .. wg*64+63
  const int wg = warp >> 2;
  const int wl = warp & 3;
  constexpr int V = RowShape<bf16, C>::V;
  constexpr int J = RowShape<bf16, C>::J;
  float gam[J][V], bet[J][V];  // the lane's gamma and beta, for all its rows
  load_lane(p.gamma, gam, lane);
  load_lane(p.beta, bet, lane);
  mbar_wait(xbar, 0);
  // LayerNorm in place: warp wl takes rows wl, wl + 4, ... of its 64; lane
  // `lane` holds the row's 16-byte chunks j * 32 + lane (ln_rows.cuh's
  // layout), chunk c in k-block c / 8 at the swizzled position (c % 8) ^
  // (row % 8)
#pragma unroll 2
  for (int i = 0; i < 16; ++i) {  // two rows in flight: their reductions overlap
    const int rr = wg * 64 + wl + 4 * i;
    bf16* chunk[J];
    float v[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      chunk[j] = a + (j * 4 + (lane >> 3)) * kRows * kAtomK + rr * kAtomK + (((lane & 7) ^ (rr & 7)) * 8);
      load_vec<V>(chunk[j], v[j]);
    }
    const float2 st = stats_of<C>(v, p.eps);
    const long long grow = row0 + rr;
    if (blockIdx.x == 0 && lane == 0 && grow < p.rows) {
      p.mu[grow] = st.x;
      p.rstd[grow] = st.y;
    }
    normalize_with(v, st, gam, bet);
#pragma unroll
    for (int j = 0; j < J; ++j) store_vec<V>(chunk[j], v[j]);
  }
  fence_proxy_async();            // the normalised rows, to wgmma
  named_barrier(1 + wg, 128);     // ... of all four warps of the warpgroup

  const bf16* a_wg = a + wg * 64 * kAtomK;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the warpgroup's first thread releases a stage for it, once its wait has
  // seen the warpgroup's products on that stage done
  const bool lead = (threadIdx.x & 127) == 0;
  const long long r_top = row0 + wg * 64 + wl * 16 + g;  // this thread's rows: r_top, r_top + 8
  const bf16* bias = static_cast<const bf16*>(p.b);
  bf16* y = static_cast<bf16*>(p.y);
  int stage = 0;
  uint32_t phase = 0;
  float acc[64] = {};
  for (int tile = tile0; tile < tile1; ++tile) {
    // the tile's bias pairs, loaded now so that the loads land during the
    // products (columns 8j + 2t, 8j + 2t + 1; none past F)
    __nv_bfloat162 bias2[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = tile * kBN + j * 8 + 2 * t;
      bias2[j] = col < p.features ? *reinterpret_cast<const __nv_bfloat162*>(bias + col)
                                  : __floats2bfloat162_rn(0.f, 0.f);
    }
    int release = -1;  // the stage whose products may still be running
    for (int ks = 0; ks < kKSteps; ++ks) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 16; ++kk) {
        const int k = ks * kStageK + kk * 16;
        const uint64_t da = wgmma_desc(a_wg + (k / kAtomK) * kRows * kAtomK + k % kAtomK, 1024, kSwizzle128);
        const uint64_t db = wgmma_desc(ws + stage * kStageBytes + kk * 32, Tiling::kAtomBytes, Tiling::kSwizzle);
        wgmma_m64n128k16(acc, da, db, ks > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (release >= 0 && lead) mbar_arrive(&empty[release]);
      release = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);  // the epilogue reads acc after the wait, not before
    if (lead) mbar_arrive(&empty[release]);

    // accumulator of m64n128: acc[4j + e] is row 16 * wl + g (+ 8 for
    // e >= 2) of the warpgroup, column 8j + 2t + (e & 1) of the tile. Each
    // quad transposes its words so that lane t holds the 8 columns of chunk
    // 4m + t: 16-byte stores, 64 contiguous bytes of a row per quad,
    // streaming (evict-first), so that y does not push W out of L2.
#pragma unroll
    for (int m = 0; m < kBN / 32; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * m + i;
          const float2 bb = __bfloat1622float2(bias2[j]);
          w[i] = pack_f32(round_then_bias(acc[4 * j + 2 * r], bb.x), round_then_bias(acc[4 * j + 2 * r + 1], bb.y));
        }
        quad_transpose(w, t);
        const long long row = r_top + 8 * r;
        const int col = tile * kBN + (4 * m + t) * 8;
        if (row < p.rows && col < p.features) {  // F is a multiple of 8: the chunk is in or out
          __stcs(reinterpret_cast<uint4*>(y + row * p.features + col), make_uint4(w[0], w[1], w[2], w[3]));
        }
      }
    }
  }
}

// Column tiles per run: the (slab, run) items go out in waves of `sms`
// blocks (one block an SM: the slab fills shared memory), each item costing
// its tiles plus about one tile's worth for its LayerNorm; the fewest runs
// of the least cost.
int tiles_per_run(long long slabs, int ntiles, int sms) {
  int best = ntiles;
  long long best_cost = -1;
  for (int runs = 1; runs <= ntiles; ++runs) {
    const int per_run = (ntiles + runs - 1) / runs;
    const long long items = slabs * ((ntiles + per_run - 1) / per_run);
    const long long cost = (items + sms - 1) / sms * (per_run + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per_run;
    }
  }
  return best;
}

template <int C>
cudaError_t launch_fwd_bf16(const LndParams& p, cudaStream_t stream) {
  using Tiling = FwdTiling<C>;
  CUtensorMap tm_x, tm_w;
  const CUtensorMapSwizzle w_swizzle = Tiling::kStageK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  if (sm90::encode_bf16_2d(&tm_x, p.x, p.rows, C, Tiling::kRows, kAtomK, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS ||
      sm90::encode_bf16_2d(&tm_w, p.w, p.features, C, kBN, Tiling::kStageK, w_swizzle) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(vitae_lnd_fwd_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tiling::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const long long slabs = (p.rows + Tiling::kRows - 1) / Tiling::kRows;
  const int ntiles = (p.features + kBN - 1) / kBN;
  const int per_run = tiles_per_run(slabs, ntiles, sms);
  const dim3 grid((ntiles + per_run - 1) / per_run, static_cast<unsigned>(slabs));
  vitae_lnd_fwd_bf16_kernel<C><<<grid, Tiling::kThreads, Tiling::kSmem, stream>>>(tm_x, tm_w, p, per_run);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 backward: dln = dY W
//
// dln (R x C, f32) = dY (R x F) W (F x C) on wgmma: a persistent block per
// SM walks 128 x 128 output tiles (column tiles fastest, so the blocks at
// work at once share their dY rows in L2); two consumer warpgroups own 64
// rows each, one producer warp streams the depth F in 64-deep stages of dY
// (128 rows, K-major) and W (64 rows of F by 128 columns: W's rows are the
// depth, so B is MN-major) through TMA, in a ring that runs on across the
// block's tiles. Each stage feeds four m64n128k16 per warpgroup; the
// previous stage is released once they run.

struct DlnTiling {
  static constexpr int kBM = 128;      // tile rows: two consumer warpgroups
  static constexpr int kStageK = 64;   // depth (features out) of a stage: 128-byte rows
  static constexpr int kConsumers = kBM / 64;
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kABytes = kBM * kStageK * 2;   // dY: 128 rows x 64, swizzled 128B
  static constexpr int kBBytes = kStageK * kBN * 2;   // W: 64 rows x 128 columns, two 64-column boxes
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = 6;
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "over the shared memory a block can use");
};

__global__ void __launch_bounds__(DlnTiling::kThreads, 1)
vitae_lnd_dln_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy, const __grid_constant__ CUtensorMap tm_w,
                           const LndParams p) {
  using T = DlnTiling;
  using namespace sm90;
  constexpr int kStages = T::kStages;
  extern __shared__ unsigned char dln_smem[];
  unsigned char* base = dln_smem + ((1024 - (smem_u32(dln_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * T::kStageBytes);
  uint64_t* empty = full + kStages;

  const int cols = p.cols;
  const int ctiles = cols / kBN;
  const int ntiles = static_cast<int>((p.rows + T::kBM - 1) / T::kBM) * ctiles;
  const int ksteps = (p.features + T::kStageK - 1) / T::kStageK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == T::kConsumers * 4) {  // the producer warp: TMA only
    if (lane == 0) {
      tma_prefetch_descriptor(&tm_dy);
      tma_prefetch_descriptor(&tm_w);
      const uint64_t streamed = l2_evict_first();     // dY: read by the C / 128 tiles of its rows
      const uint64_t shared_by_all = l2_evict_last();  // W: read by every tile
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int r0 = (tile / ctiles) * T::kBM;
        const int c0 = (tile % ctiles) * kBN;
        for (int ks = 0; ks < ksteps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = base + stage * T::kStageBytes;
          mbar_arrive_expect_tx(&full[stage], T::kStageBytes);
          tma_load_2d(st, &tm_dy, ks * T::kStageK, r0, &full[stage], streamed);
          tma_load_2d(st + T::kABytes, &tm_w, c0, ks * T::kStageK, &full[stage], shared_by_all);
          tma_load_2d(st + T::kABytes + T::kBBytes / 2, &tm_w, c0 + 64, ks * T::kStageK, &full[stage],
                      shared_by_all);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool lead = (threadIdx.x & 127) == 0;
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = (long long)(tile / ctiles) * T::kBM;
    const int c0 = (tile % ctiles) * kBN;
    int release = -1;  // the stage whose products may still be running
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = base + stage * T::kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::kStageK / 16; ++kk) {
        // A: the warpgroup's 64 dY rows, K-major; B: the W stage, MN-major
        // (two 64-column boxes T::kBBytes / 2 apart, 8-deep groups 1,024 apart)
        const uint64_t da = wgmma_desc(st + wg * 64 * 128 + kk * 32, 1024, kSwizzle128);
        const uint64_t db = wgmma_desc_mn(st + T::kABytes + kk * 2048, T::kBBytes / 2, 1024, kSwizzle128);
        Wgmma<128>::ss<1>(acc, da, db, ks > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (release >= 0 && lead) mbar_arrive(&empty[release]);
      release = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lead) mbar_arrive(&empty[release]);

    // acc[4j + e]: row 16 * wl + g (+ 8 for e >= 2) of the warpgroup,
    // column 8j + 2t + (e & 1) of the tile. Lanes t and t ^ 1 swap one pair
    // of each two 8-column blocks, so that each stores 4 contiguous floats
    // (16 bytes, streaming: dln is read once, by the row pass)
    const long long row_top = r0 + wg * 64 + wl * 16 + g;
    const bool odd = t & 1;
#pragma unroll
    for (int m = 0; m < kBN / 16; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j0 = 2 * m, j1 = 2 * m + 1;
        const float send_x = odd ? acc[4 * j0 + 2 * r] : acc[4 * j1 + 2 * r];
        const float send_y = odd ? acc[4 * j0 + 2 * r + 1] : acc[4 * j1 + 2 * r + 1];
        const float got_x = __shfl_xor_sync(0xffffffffu, send_x, 1);
        const float got_y = __shfl_xor_sync(0xffffffffu, send_y, 1);
        const float4 v = odd ? make_float4(got_x, got_y, acc[4 * j1 + 2 * r], acc[4 * j1 + 2 * r + 1])
                             : make_float4(acc[4 * j0 + 2 * r], acc[4 * j0 + 2 * r + 1], got_x, got_y);
        const int col = c0 + 8 * (odd ? j1 : j0) + 2 * (t & 2);
        const long long row = row_top + 8 * r;
        if (row < p.rows) __stcs(reinterpret_cast<float4*>(p.dln + row * cols + col), v);
      }
    }
  }
}

cudaError_t launch_dln_bf16(const LndParams& p, cudaStream_t stream) {
  using T = DlnTiling;
  CUtensorMap tm_dy, tm_w;
  if (sm90::encode_bf16_2d(&tm_dy, p.dy, p.rows, p.features, T::kBM, T::kStageK, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS ||
      sm90::encode_bf16_2d(&tm_w, p.w, p.features, p.cols, T::kStageK, 64, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaFuncSetAttribute(vitae_lnd_dln_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const long long tiles = (p.rows + T::kBM - 1) / T::kBM * (p.cols / kBN);
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  vitae_lnd_dln_wgmma_kernel<<<grid, T::kThreads, T::kSmem, stream>>>(tm_dy, tm_w, p);
  return cudaGetLastError();
}

// ------------------------------------------------- f32: 3xTF32 on wgmma
//
// Both f32 products run on one kernel, out (R x N) = A (R x K) B^T with B
// (N x K), f32-accurate as 3xTF32 (flash_common.cuh): each operand split
// into tf32 hi and lo, a product a * b taken as a.lo b.hi + a.hi b.lo +
// a.hi b.hi. The forward: A = x normalised on the way in (kNorm), B = W
// (F x C), N = F, K = C, the f32 bias added; the dln product: A = dY, B =
// W^T (C x F), N = C, K = F. tf32 wgmma reads only K-major operands, and
// W's rows run along C: the forward's B is K-major as stored, the dln
// product's is not. So a pre-pass (vitae_tf32_split_kernel) splits W once
// per call into hi and lo copies in the product's layout (F x C, or
// transposed to C x F), 2 x 4 bytes an element of device memory (6 to 19
// MB at the model's shapes, L2 keeps them), and TMA loads them as they are.
// A stays raw f32: TMA brings it in 32-deep stages; each thread reads its
// fragment from shared memory, normalises it (forward: (x - mu) rstd gamma
// + beta, mu and rstd from the statistics pass before, which writes them
// for the backward too) and splits it in registers: wgmma's register A
// form. The normalised rows never reach device memory.
// Tiles of 128 x 128, two consumer warpgroups of 64 rows and a producer
// warpgroup (one thread issues the TMA loads; the warpgroup hands its
// registers to the consumers through setmaxnreg), persistent blocks, a ring
// of four 48 KB stages (A 16 KB, B hi and lo 16 KB each, swizzled 128B)
// running on across tiles. Per stage a warpgroup issues 4 k8 steps x 3
// m64n128k8 into a fresh accumulator, which is then added to the f32
// register sum: the tensor cores' f32 sums truncate, so no accumulator sums
// more than one 32-deep chunk (12 products); the sum over chunks rounds to
// nearest. While a chunk's products run, the warpgroup loads, normalises
// and splits the next chunk's fragments: 232 registers a consumer thread
// hold both chunks' fragments beside the accumulator and the sum (with a
// producer warp and no reallocation, the 168 registers a thread gets at
// 288 threads spilled).
// The depth order: a thread's A fragment wants depth t and t + 4 of each k8
// step (g = lane / 4, t = lane % 4), four scalars scattered over the 128
// bytes of a row; the split copies of B store each 32-wide group of the
// depth permuted (tf32_perm), so that the thread's 4 k8 steps read depth
// 8t .. 8t + 7 of its rows in the original order: two 16-byte loads a row
// (conflict-free under the swizzle) and two of gamma and of beta.
// What bounds it: each 48 KB stage feeds 3.1 MFLOP of tf32 products (1
// MFLOP of f32 ones), so at the f32 bound (495 / 3 TFLOP/s) the 132 SMs
// would pull ~7.7 TB/s of L2; the split B copies double W's share of it.
// In the f32 training step on an H100 the product runs near 110 TFLOP/s
// (chip_smoke.py's profile), about 5 TB/s of L2 traffic.

constexpr int kTfBM = 128;     // tile rows: two consumer warpgroups of 64
constexpr int kTfStageK = 32;  // depth of a stage and of a chunk: one 128-byte f32 row
constexpr int kTfConsumers = kTfBM / 64;
constexpr int kTfThreads = (kTfConsumers + 1) * 128;  // and a producer warpgroup
// registers a thread: 168 at launch (65,536 over 384 threads); the producer
// warpgroup gives back all but 40 and each consumer takes 232 (two
// accumulators of 64 and two chunks' A fragments of 32)
constexpr int kTfProducerRegs = 40;
constexpr int kTfConsumerRegs = 232;
static_assert(kTfProducerRegs * 128 + kTfConsumerRegs * 128 * kTfConsumers <= 65536, "over the SM's registers");
constexpr int kTfABytes = kTfBM * kTfStageK * 4;  // A: 128 rows x 32, swizzled 128B
constexpr int kTfBBytes = kBN * kTfStageK * 4;    // B hi or lo: 128 rows (of N) x 32
constexpr int kTfStageBytes = kTfABytes + 2 * kTfBBytes;
constexpr int kTfStages = 4;
constexpr int kTfSmem = 1024 + kTfStages * kTfStageBytes + 2 * kTfStages * 8;
static_assert(kTfSmem <= 232448, "over the shared memory a block can use");

// Physical column p of each 32-wide depth group of the split B holds depth
// tf32_perm(p): p = 8 kk + 4 h + t (k8 step kk, fragment half h, t = lane %
// 4) holds 8 t + 2 kk + h, so that lane t's fragments over the stage's four
// k8 steps cover depth 8t .. 8t + 7.
__host__ __device__ constexpr int tf32_perm(int p) { return 8 * (p & 3) + 2 * (p >> 3) + ((p >> 2) & 1); }

// W (F x C, f32) -> hi and lo tf32 bit patterns (as f32 words), each
// 32-wide depth group permuted by tf32_perm: (F x C), depth C, for the
// forward; transposed, (C x F), depth F, for the dln product. A 32 x 32
// tile of W a block, through shared memory; reads and writes coalesced.
template <bool kTranspose>
__global__ void __launch_bounds__(256) vitae_tf32_split_kernel(const float* w, float* hi, float* lo, int features,
                                                               int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32;
  const int f0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < 32; i += 8) tile[i][tx] = w[(long long)(f0 + i) * cols + c0 + tx];
  __syncthreads();
  const int src = tf32_perm(tx);
  for (int i = threadIdx.x >> 5; i < 32; i += 8) {
    const Tf32x2 s = split_tf32(kTranspose ? tile[src][i] : tile[i][src]);
    const long long at = kTranspose ? (long long)(c0 + i) * features + f0 + tx : (long long)(f0 + i) * cols + c0 + tx;
    hi[at] = __uint_as_float(s.hi);
    lo[at] = __uint_as_float(s.lo);
  }
}

// mu and rstd of every row of x (R x C, f32), one warp a row: the forward's
// statistics, read by the product and kept for the backward.
template <int C>
__global__ void __launch_bounds__(kRowThreads) vitae_lnd_stats_f32_kernel(const LndParams p) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  float v[RowShape<float, C>::J][RowShape<float, C>::V];
  const float2 st = row_stats<float, C>(static_cast<const float*>(p.x) + row * C, v, lane, p.eps);
  if (lane == 0) {
    p.mu[row] = st.x;
    p.rstd[row] = st.y;
  }
}

// One chunk's A fragments of a thread, tf32 hi and lo, for its 4 k8 steps.
struct TfFrag {
  uint32_t hi[4][4], lo[4][4];
};

// Keeps the compiler from reusing a fragment's registers before the wgmma
// that reads them has been waited for.
__device__ __forceinline__ void fence_frag(TfFrag& f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.hi[kk][i]), "+r"(f.lo[kk][i])::"memory");
  }
}

// Depth 8t .. 8t + 7 of row `row` of an A stage (128-byte rows, 16-byte
// chunk c stored at c ^ (row % 8)): chunks 2t and 2t + 1.
__device__ __forceinline__ void load_depth8(const unsigned char* stage, int row, int t, float (&v)[8]) {
  const unsigned char* r = stage + row * 128;
  const float4 a = *reinterpret_cast<const float4*>(r + (((2 * t) ^ (row & 7)) << 4));
  const float4 b = *reinterpret_cast<const float4*>(r + (((2 * t + 1) ^ (row & 7)) << 4));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
  v[4] = b.x;
  v[5] = b.y;
  v[6] = b.z;
  v[7] = b.w;
}

// A thread's fragments of chunk ks from its A stage: its two rows' depth
// 8t .. 8t + 7, normalised in the forward ((x - mu) rstd gamma + beta; st
// = (mu, rstd)), split into tf32 hi and lo. k8 step kk's fragment is
// (row g, t), (row g + 8, t), (g, t + 4), (g + 8, t + 4) of the permuted
// depth: depth 8t + 2kk (+ 1).
template <bool kNorm>
__device__ __forceinline__ void load_frag(const unsigned char* stage, int ks, int row, int t, float2 top_st,
                                          float2 bot_st, const float* gamma, const float* beta, TfFrag& f) {
  float top[8], bot[8];
  load_depth8(stage, row, t, top);
  load_depth8(stage, row + 8, t, bot);
  if constexpr (kNorm) {
    float gam[8], bet[8];
    load_vec<8>(gamma + ks * kTfStageK + 8 * t, gam);
    load_vec<8>(beta + ks * kTfStageK + 8 * t, bet);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      top[i] = ((top[i] - top_st.x) * top_st.y) * gam[i] + bet[i];
      bot[i] = ((bot[i] - bot_st.x) * bot_st.y) * gam[i] + bet[i];
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Tf32x2 u = split_tf32(top[2 * kk + h]);
      const Tf32x2 v = split_tf32(bot[2 * kk + h]);
      f.hi[kk][2 * h] = u.hi;
      f.lo[kk][2 * h] = u.lo;
      f.hi[kk][2 * h + 1] = v.hi;
      f.lo[kk][2 * h + 1] = v.lo;
    }
  }
}

template <bool kNorm>
__global__ void __launch_bounds__(kTfThreads, 1)
vitae_lnd_tf32_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_hi,
                      const __grid_constant__ CUtensorMap tm_lo, const LndParams p) {
  using namespace sm90;
  extern __shared__ unsigned char tf_smem[];
  unsigned char* base = tf_smem + ((1024 - (smem_u32(tf_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kTfStages * kTfStageBytes);
  uint64_t* empty = full + kTfStages;

  const int n_out = kNorm ? p.features : p.cols;
  const int ntn = (n_out + kBN - 1) / kBN;
  const int ntiles = static_cast<int>((p.rows + kTfBM - 1) / kTfBM) * ntn;
  const int chunks = (kNorm ? p.cols : p.features) / kTfStageK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTfConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: its registers to the consumers, TMA from one thread
    setmaxnreg_dec<kTfProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_descriptor(&tm_a);
      tma_prefetch_descriptor(&tm_hi);
      tma_prefetch_descriptor(&tm_lo);
      const uint64_t streamed = l2_evict_first();      // A: read by the column tiles of its rows
      const uint64_t shared_by_all = l2_evict_last();  // the split W: read by every row tile
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int r0 = (tile / ntn) * kTfBM;
        const int n0 = (tile % ntn) * kBN;
        for (int ks = 0; ks < chunks; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = base + stage * kTfStageBytes;
          mbar_arrive_expect_tx(&full[stage], kTfStageBytes);
          tma_load_2d(st, &tm_a, ks * kTfStageK, r0, &full[stage], streamed);
          tma_load_2d(st + kTfABytes, &tm_hi, ks * kTfStageK, n0, &full[stage], shared_by_all);
          tma_load_2d(st + kTfABytes + kTfBBytes, &tm_lo, ks * kTfStageK, n0, &full[stage], shared_by_all);
          if (++stage == kTfStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  setmaxnreg_inc<kTfConsumerRegs>();

  const int wg = (warp >> 2) - 1;
  const int wl = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool lead = (threadIdx.x & 127) == 0;
  const int row_in_tile = wg * 64 + wl * 16 + g;  // this thread's rows of the tile: row_in_tile and + 8
  int stage = 0;
  uint32_t phase = 0;
  float acc[64], sum[64];
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long r0 = (long long)(tile / ntn) * kTfBM;
    const int n0 = (tile % ntn) * kBN;
    const long long row_top = r0 + row_in_tile;
    float2 top_st = make_float2(0.f, 0.f), bot_st = top_st;  // (mu, rstd); rows past R: zeros, never stored
    if constexpr (kNorm) {
      if (row_top < p.rows) top_st = make_float2(p.mu[row_top], p.rstd[row_top]);
      if (row_top + 8 < p.rows) bot_st = make_float2(p.mu[row_top + 8], p.rstd[row_top + 8]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.f;
    TfFrag cur;
    mbar_wait(&full[stage], phase);
    load_frag<kNorm>(base + stage * kTfStageBytes, 0, row_in_tile, t, top_st, bot_st, p.gamma, p.beta, cur);
    for (int ks = 0; ks < chunks; ++ks) {
      const unsigned char* st = base + stage * kTfStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b_hi = wgmma_desc(st + kTfABytes + kk * 32, 1024, kSwizzle128);
        const uint64_t b_lo = wgmma_desc(st + kTfABytes + kTfBBytes + kk * 32, 1024, kSwizzle128);
        WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);  // the chunk starts a fresh accumulator
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_lo, 1);
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_hi, 1);
      }
      wgmma_commit();
      // the next chunk's fragments while these products run
      const int next = stage + 1 == kTfStages ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      TfFrag nxt;
      if (ks + 1 < chunks) {
        mbar_wait(&full[next], next_phase);
        load_frag<kNorm>(base + next * kTfStageBytes, ks + 1, row_in_tile, t, top_st, bot_st, p.gamma, p.beta,
                         nxt);
      }
      wgmma_wait<0>();
      fence_operands(acc);
      fence_frag(cur);
      if (lead) mbar_arrive(&empty[stage]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      cur = nxt;
      stage = next;
      phase = next_phase;
    }

    // sum[4j + e]: row row_top (+ 8 for e >= 2), column n0 + 8j + 2t + (e &
    // 1). The forward adds the f32 bias; then lanes t and t ^ 1 swap one
    // pair of each two 8-column blocks, so that each stores 4 contiguous
    // floats (16-byte streaming stores), columns past N masked (N is a
    // multiple of 32: a store is wholly in or out).
    float* out = kNorm ? static_cast<float*>(p.y) : p.dln;
    if constexpr (kNorm) {
      const float* bias = static_cast<const float*>(p.b);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < n_out) {
          const float2 bb = *reinterpret_cast<const float2*>(bias + col);
          sum[4 * j] += bb.x;
          sum[4 * j + 1] += bb.y;
          sum[4 * j + 2] += bb.x;
          sum[4 * j + 3] += bb.y;
        }
      }
    }
    const bool odd = t & 1;
#pragma unroll
    for (int m = 0; m < kBN / 16; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j0 = 2 * m, j1 = 2 * m + 1;
        const float send_x = odd ? sum[4 * j0 + 2 * r] : sum[4 * j1 + 2 * r];
        const float send_y = odd ? sum[4 * j0 + 2 * r + 1] : sum[4 * j1 + 2 * r + 1];
        const float got_x = __shfl_xor_sync(0xffffffffu, send_x, 1);
        const float got_y = __shfl_xor_sync(0xffffffffu, send_y, 1);
        const float4 v = odd ? make_float4(got_x, got_y, sum[4 * j1 + 2 * r], sum[4 * j1 + 2 * r + 1])
                             : make_float4(sum[4 * j0 + 2 * r], sum[4 * j0 + 2 * r + 1], got_x, got_y);
        const int col = n0 + 8 * (odd ? j1 : j0) + 2 * (t & 2);
        const long long row = row_top + 8 * r;
        if (row < p.rows && col < n_out) __stcs(reinterpret_cast<float4*>(out + row * n_out + col), v);
      }
    }
  }
}

// The f32 forward (kNorm: the statistics pass first) or dln product: the
// split of W, then the product.
template <bool kNorm>
cudaError_t launch_tf32(const LndParams& p, cudaStream_t stream) {
  const int n_out = kNorm ? p.features : p.cols;
  const int depth = kNorm ? p.cols : p.features;
  vitae_tf32_split_kernel<!kNorm><<<dim3(p.cols / 32, p.features / 32), 256, 0, stream>>>(
      static_cast<const float*>(p.w), p.w_hi, p.w_lo, p.features, p.cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap tm_a, tm_hi, tm_lo;
  if (sm90::encode_f32_2d(&tm_a, kNorm ? p.x : p.dy, p.rows, depth, kTfBM, kTfStageK, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS ||
      sm90::encode_f32_2d(&tm_hi, p.w_hi, n_out, depth, kBN, kTfStageK, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS ||
      sm90::encode_f32_2d(&tm_lo, p.w_lo, n_out, depth, kBN, kTfStageK, CU_TENSOR_MAP_SWIZZLE_128B) !=
          CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  err = cudaFuncSetAttribute(vitae_lnd_tf32_kernel<kNorm>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTfSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
  const long long tiles = (p.rows + kTfBM - 1) / kTfBM * ((n_out + kBN - 1) / kBN);
  const dim3 grid(static_cast<unsigned>(tiles < sms ? tiles : sms));
  vitae_lnd_tf32_kernel<kNorm><<<grid, kTfThreads, kTfSmem, stream>>>(tm_a, tm_hi, tm_lo, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- launches

template <int C>
cudaError_t launch_fwd_c(const LndParams& p, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_fwd_bf16<C>(p, stream);
  const dim3 grid(static_cast<unsigned>((p.rows + kRowThreads / 32 - 1) / (kRowThreads / 32)));
  vitae_lnd_stats_f32_kernel<C><<<grid, kRowThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : launch_tf32<true>(p, stream);
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
  const cudaError_t err = is_bf16 ? launch_dln_bf16(*p, s) : launch_tf32<false>(*p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const lnrows::RowBwdArgs a{p->x, p->dln, p->gamma, p->mu, p->rstd, p->dx, p->rows};
  return static_cast<int>(is_bf16 ? lnrows::launch_rows_bwd<__nv_bfloat16, float>(a, p->cols, s)
                                  : lnrows::launch_rows_bwd<float, float>(a, p->cols, s));
}

const char* ln_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
