#!/usr/bin/env python3
"""Mutation check of the CUDA kernels' tolerances, on one NVIDIA GPU.

    python3 kernel_mutants.py

Run from the root of a checkout. For each mutant below it copies the port
(`vit_ae_plus_plus_torch/`, `chip_smoke.py`, the CUDA kernel tests) into
`vit_ae_plus_plus_torch/build/mutants/<name>/` and breaks one file there on
purpose. A kernel mutant breaks a source under `kernels/csrc/`; every such
copy is built at once, and two checks run against each broken kernel:

- `tests/test_torch_port_kernels_cuda.py`, the kernels against their plain
  versions at small ragged shapes;
- at a main-path shape: `chip_smoke.kernel_case` at the serving shape
  (packed, B=8, N=1729, C=768, d=64, bf16) for a forward mutant, and in
  f32 (the f32 slab's shape) for an f32-forward mutant,
  `chip_smoke.bwd_case` at the decoder's training shape (packed, B=8,
  N=1729, C=512, d=32, bf16) for a backward mutant, and in f32 for a
  mutant of the f32 (3xTF32 wgmma) backward; at the `_fast` preset's
  decoder shape (packed, B=8, H=4, N=1729, d=128, f32) for a mutant of the
  d = 128 dV, dK or dQ kernel;
  `chip_smoke.ln_dense_cases` at the training encoder's qkv shape (R=6928,
  C=768, F=2304, bf16, forward and backward) for a LayerNorm+Dense or
  LayerNorm row-pass mutant, and at the decoder's qkv shape (R=13832,
  C=512, F=1536) in f32 for a mutant of the f32 (3xTF32) bodies;
  `chip_smoke.ring_case` at the feature path's
  ring block (B=2, H=12, 1,032 rows, d=64, bf16, the block with 31 pad
  keys) for a key-bias mutant; `chip_smoke.seq_case` at the
  sequence-sharded shape (1,032 queries against 4,097 keys) for a kv_len
  mutant.

A schedule mutant breaks the ring's or the sequence-sharded path's Python
(`kernels/ring_flash.py`, `kernels/seq_flash.py`: the rotations, the merge,
the final hop home, the sum over ranks) and loads the unbroken kernels,
built once in the checkout. The CUDA kernel tests run no group of ranks, so
one check runs against it: `chip_smoke`'s phase 7a, ring and sequence-sharded
attention at B=2, H=12, N=4,097, d=64 in 4 ranks on the card against
`flash_attention`.

The int8 mutant breaks the int8 engine's dequantise (`models/quant.py`,
the per-token activation scale dropped) and loads the unbroken kernels,
as a schedule mutant does; its one check is `chip_smoke.int8_case`, phase
4c's int8 `FeatureEngine` against the bf16 one at the full-width slab.
Two more break the pretraining options of phase 5i the same way: the
VGG16's convolutions left to TF32 (`models/vgg.py`; check
`chip_smoke.perceptual_case`, the term against the VGG in f64) and the
accumulator summing the mini-steps' gradients (`train/optim.py`; check
`chip_smoke.accum_case`, the update against one AdamW update on the mean
gradient).

Each check must fail: a tolerance loose enough to pass a broken kernel or
schedule shows here. The mutants' checks run four at a time on the one card (each is a
correctness check, none is timed). Prints one line per mutant and exits 0
only when every mutant is caught by both checks.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = Path("vit_ae_plus_plus_torch")
KERNEL_TESTS = Path("tests/test_torch_port_kernels_cuda.py")
FWD_CASE = "chip_smoke.kernel_case('packed bf16 N1729 d64', 'packed', 8, 12, 1729, 64, 'bfloat16', seed=0)"
F32_CASE = "chip_smoke.kernel_case('packed f32 N1729 d64', 'packed', 8, 12, 1729, 64, 'float32', seed=4)"
BWD_CASE = "chip_smoke.bwd_case('packed bwd bf16 N1729 d32', 'packed', 8, 16, 1729, 32, 'bfloat16', seed=13)"
F32_BWD_CASE = "chip_smoke.bwd_case('packed bwd f32 N1729 d32', 'packed', 8, 16, 1729, 32, 'float32', seed=18)"
F32_BWD128_CASE = "chip_smoke.bwd_case('packed bwd f32 N1729 d128', 'packed', 8, 4, 1729, 128, 'float32', seed=27)"
LND_CASE = "chip_smoke.ln_dense_cases('ln_dense bf16 encoder qkv', 6928, 768, 2304, 'bfloat16', seed=40)"
LND_F32_CASE = "chip_smoke.ln_dense_cases('ln_dense f32 decoder qkv', 13832, 512, 1536, 'float32', seed=52)"
RING_CASE = "chip_smoke.ring_case('ring bf16 NB1032', 2, 12, 4097, 64, 4, seed=70)"
SEQ_CASE = "chip_smoke.seq_case('seq bf16 N1032 Nk4097', 2, 12, 4097, 64, 4, seed=80)"
GROUP_CASE = "chip_smoke.check_group_attention(chip_smoke.run_group(chip_smoke.attention_rank))"
INT8_CASE = "chip_smoke.int8_case()"
PERCEPTUAL_CASE = "chip_smoke.perceptual_case()"
ACCUM_CASE = "chip_smoke.accum_case()"
# name -> (file under the package, text in it, its broken replacement at
# every occurrence, main-path check); a kernel mutant's file is under
# kernels/csrc/
MUTANTS = {
    "drop_last_key_tile": (  # the bf16 forward walks one key tile fewer: the ragged last one is left out
        "kernels/csrc/flash_fwd.cu",
        "const int ktiles = (keys + kBlock - 1) / kBlock;",
        "const int ktiles = (keys - 1) / kBlock;",
        FWD_CASE,
    ),
    "unmasked_key_tail": (  # the first key past kv_len counts (a zero row of K and V)
        "kernels/csrc/flash_fwd.cu",
        "(i & 1) >= keys ?",
        "(i & 1) > keys ?",
        FWD_CASE,
    ),
    "scale_off_1pct": (
        "kernels/csrc/flash_fwd.cu",
        "const float scale_log2 = p.scale * kLog2e;",
        "const float scale_log2 = p.scale * kLog2e * 1.01f;",
        FWD_CASE,
    ),
    "fwd_no_rescale": (  # O is not scaled by alpha when the running max grows
        "kernels/csrc/flash_fwd.cu",
        "o[i] *= alpha[(i >> 1) & 1];",
        "o[i] *= 1.f;",
        FWD_CASE,
    ),
    "fwd_v_not_transposed": (  # O += P V reads the MN-major V tile as K-major
        "kernels/csrc/flash_fwd.cu",
        "Wgmma<D>::template rs<1>(o, pa[kk], desc_mn<D>(vs, kk), 1)",
        "Wgmma<D>::template rs<0>(o, pa[kk], desc_mn<D>(vs, kk), 1)",
        FWD_CASE,
    ),
    "bwd_drop_last_query_tile": (  # the dK/dV ring skips its last stage: the ragged last query tile
        "kernels/csrc/flash_bwd.cu",
        "for (int qt = 0; qt < qtiles; ++qt)",
        "for (int qt = 0; qt + 1 < qtiles; ++qt)",
        BWD_CASE,
    ),
    "bwd_dq_drop_last_key_tile": (  # the dQ ring skips its last stage: the ragged last key tile
        "kernels/csrc/flash_bwd.cu",
        "for (int kt = 0; kt < ktiles; ++kt)",
        "for (int kt = 0; kt + 1 < ktiles; ++kt)",
        BWD_CASE,
    ),
    "bwd_no_delta": (  # dS = P * dP, delta = rowsum(dO * O) left out
        "kernels/csrc/flash_bwd.cu",
        "if (lane == 0) p.delta[r] = acc;",
        "if (lane == 0) p.delta[r] = 0.f;",
        BWD_CASE,
    ),
    "bwd_dk_unscaled": (  # dK = dS^T Q without the softmax scale
        "kernels/csrc/flash_bwd.cu",
        "store_tile<D>(dk, p.scale,",
        "store_tile<D>(dk, 1.f,",
        BWD_CASE,
    ),
    "bwd_dv_b_not_transposed": (  # dV += P^T dO reads the MN-major dO tile as K-major
        "kernels/csrc/flash_bwd.cu",
        "Wgmma<D>::template rs<1>(dv, pa[kk]",
        "Wgmma<D>::template rs<0>(dv, pa[kk]",
        BWD_CASE,
    ),
    "bwd_scores_not_reset": (  # S^T accumulates over the query tiles instead of starting afresh
        "kernels/csrc/flash_bwd.cu",
        "Wgmma<64>::ss<0>(st, desc_k<D>(ks, kk), desc_k<D>(qs, kk), kk > 0)",
        "Wgmma<64>::ss<0>(st, desc_k<D>(ks, kk), desc_k<D>(qs, kk), 1)",
        BWD_CASE,
    ),
    "f32_bwd_dkdv_tf32_low_terms_dropped": (  # dV += P^T dO and dK += dS^T Q in plain TF32: hi * hi alone
        "kernels/csrc/flash_bwd.cu",
        """    if constexpr (DV) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);  // P^T dO, B = dO^T
    if constexpr (DK) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS^T Q, B = Q^T""",
        """    if constexpr (DV) for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dv_chunk, pa_hi[kk], desc_tf32_t<D, kRows>(dot_hi, kk), kk > 0);
    if constexpr (DK) for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dk_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), kk > 0);""",
        F32_BWD_CASE,
    ),
    "f32_bwd_dq_tf32_low_terms_dropped": (  # dQ += dS K in plain TF32
        "kernels/csrc/flash_bwd.cu",
        "    chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS K, B = K^T",
        "    for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dq_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), kk > 0);",
        F32_BWD_CASE,
    ),
    "f32_bwd_drop_last_query_stage": (  # the f32 dK/dV ring skips its last stage: the ragged last 32 queries
        "kernels/csrc/flash_bwd.cu",
        "const int qtiles = (n + kRows - 1) / kRows;",
        "const int qtiles = (n - 1) / kRows;",
        F32_BWD_CASE,
    ),
    "f32_bwd_drop_last_key_stage": (  # the f32 dQ ring skips its last stage: the ragged last 32 keys
        "kernels/csrc/flash_bwd.cu",
        "const int ktiles = (nk + kRows - 1) / kRows;",
        "const int ktiles = (nk - 1) / kRows;",
        F32_BWD_CASE,
    ),
    "f32_bwd_chunk_acc_not_reset": (  # a stage's dK, dV or dQ accumulator starts from the last stage's
        "kernels/csrc/flash_sm90.cuh",
        "sm90::WgmmaTf32<D>::rs(d, a_lo[kk], desc_tf32_t<D, T>(b_hi, kk), kk > 0);",
        "sm90::WgmmaTf32<D>::rs(d, a_lo[kk], desc_tf32_t<D, T>(b_hi, kk), 1);",
        F32_BWD_CASE,
    ),
    # the d = 128 kernels, one at a time (each edit leaves the other
    # instances as they are)
    "f32_bwd_d128_dv_low_terms_dropped": (  # the dV kernel's dV += P^T dO in plain TF32
        "kernels/csrc/flash_bwd.cu",
        "    if constexpr (DV) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);  // P^T dO, B = dO^T",
        """    if constexpr (DV && DK) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);
    if constexpr (DV && !DK) for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dv_chunk, pa_hi[kk], desc_tf32_t<D, kRows>(dot_hi, kk), kk > 0);""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dv_drop_last_stage": (  # the dV kernel skips its last stage: the ragged last 32 queries
        "kernels/csrc/flash_bwd.cu",
        "const int qtiles = (n + kRows - 1) / kRows;",
        "const int qtiles = (n + kRows - 1) / kRows - (DV && !DK);",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dv_chunk_acc_not_reset": (  # the dV kernel's chunk starts from the last chunk's accumulator
        "kernels/csrc/flash_bwd.cu",
        "    if constexpr (DV) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);  // P^T dO, B = dO^T",
        """    if constexpr (DV && DK) chunk_3xtf32<D, kRows>(dv_chunk, pa_hi, pa_lo, dot_hi, dot_hi + kRow);
    if constexpr (DV && !DK) for (int kk = 0; kk < kRows / 8; ++kk) {
      WgmmaTf32<D>::rs(dv_chunk, pa_lo[kk], desc_tf32_t<D, kRows>(dot_hi, kk), 1);
      WgmmaTf32<D>::rs(dv_chunk, pa_hi[kk], desc_tf32_t<D, kRows>(dot_hi + kRow, kk), 1);
      WgmmaTf32<D>::rs(dv_chunk, pa_hi[kk], desc_tf32_t<D, kRows>(dot_hi, kk), 1);
    }""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dk_low_terms_dropped": (  # the dK kernel's dK += dS^T Q in plain TF32
        "kernels/csrc/flash_bwd.cu",
        "    if constexpr (DK) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS^T Q, B = Q^T",
        """    if constexpr (DK && DV) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);
    if constexpr (DK && !DV) for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dk_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), kk > 0);""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dk_drop_last_stage": (  # the dK kernel skips its last stage: the ragged last 16 queries
        "kernels/csrc/flash_bwd.cu",
        "const int qtiles = (n + kRows - 1) / kRows;",
        "const int qtiles = (n + kRows - 1) / kRows - (DK && !DV);",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dk_chunk_acc_not_reset": (  # the dK kernel's chunk starts from the last chunk's accumulator
        "kernels/csrc/flash_bwd.cu",
        "    if constexpr (DK) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS^T Q, B = Q^T",
        """    if constexpr (DK && DV) chunk_3xtf32<D, kRows>(dk_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);
    if constexpr (DK && !DV) for (int kk = 0; kk < kRows / 8; ++kk) {
      WgmmaTf32<D>::rs(dk_chunk, da_lo[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), 1);
      WgmmaTf32<D>::rs(dk_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 5 * kRow, kk), 1);
      WgmmaTf32<D>::rs(dk_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), 1);
    }""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dq_low_terms_dropped": (  # the dQ kernel's dQ += dS K in plain TF32 at d = 128
        "kernels/csrc/flash_bwd.cu",
        "    chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS K, B = K^T",
        """    if constexpr (D != 128) chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);
    if constexpr (D == 128) for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(dq_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), kk > 0);""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dq_drop_last_stage": (  # the dQ kernel at d = 128 skips its last stage: the ragged last 16 keys
        "kernels/csrc/flash_bwd.cu",
        "const int ktiles = (nk + kRows - 1) / kRows;",
        "const int ktiles = (nk + kRows - 1) / kRows - (D == 128);",
        F32_BWD128_CASE,
    ),
    "f32_bwd_d128_dq_chunk_acc_not_reset": (  # the dQ kernel's chunk at d = 128 starts from the last chunk's
        "kernels/csrc/flash_bwd.cu",
        "    chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);  // dS K, B = K^T",
        """    if constexpr (D != 128) chunk_3xtf32<D, kRows>(dq_chunk, da_hi, da_lo, st + 4 * kRow, st + 5 * kRow);
    if constexpr (D == 128) for (int kk = 0; kk < kRows / 8; ++kk) {
      WgmmaTf32<D>::rs(dq_chunk, da_lo[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), 1);
      WgmmaTf32<D>::rs(dq_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 5 * kRow, kk), 1);
      WgmmaTf32<D>::rs(dq_chunk, da_hi[kk], desc_tf32_t<D, kRows>(st + 4 * kRow, kk), 1);
    }""",
        F32_BWD128_CASE,
    ),
    "f32_bwd_copies_not_permuted": (  # the transposed copies in token order, the A fragments permuted
        "kernels/csrc/flash_bwd.cu",
        "split_tf32(tile[(pos & ~7) + tf32_token(pos & 7)][c])",
        "split_tf32(tile[pos][c])",
        F32_BWD_CASE,
    ),
    "f32_bwd_no_delta": (  # the f32 backward's dS = P * dP: delta left out
        "kernels/csrc/flash_bwd.cu",
        "if (lane == 0) p.delta[r] = acc;",
        "if (lane == 0) p.delta[r] = 0.f;",
        F32_BWD_CASE,
    ),
    "lnd_bias_before_rounding": (  # y = bf16(acc + b): the bias added before acc is rounded
        "kernels/csrc/ln_dense.cu",
        "return __bfloat162float(__float2bfloat16(acc)) + bias;",
        "return acc + bias;",
        LND_CASE,
    ),
    "lnd_stage_last_k16_dropped": (  # the wgmma forward skips the last 16-deep step of every W stage
        "kernels/csrc/ln_dense.cu",
        "for (int kk = 0; kk < kStageK / 16; ++kk)",
        "for (int kk = 0; kk + 1 < kStageK / 16; ++kk)",
        LND_CASE,
    ),
    "lnd_rstd_not_stored": (  # the slab's LayerNorm leaves rstd unwritten
        "kernels/csrc/ln_dense.cu",
        "      p.rstd[grow] = st.y;\n",
        "",
        LND_CASE,
    ),
    "f32_fwd_tf32_low_terms_dropped": (  # the f32 forward's P V in plain TF32: hi * hi alone
        "kernels/csrc/flash_fwd.cu",
        "chunk_3xtf32<D, kRows>(chunk, pa_hi, pa_lo, st + 2 * kRow, st + 3 * kRow);  // P V, B = V^T",
        "for (int kk = 0; kk < kRows / 8; ++kk) WgmmaTf32<D>::rs(chunk, pa_hi[kk], desc_tf32_t<D, kRows>(st + 2 * kRow, kk), kk > 0);",
        F32_CASE,
    ),
    "f32_fwd_drop_last_key_tile": (  # the f32 forward's ring skips its last stage: the ragged last keys
        "kernels/csrc/flash_fwd.cu",
        "const int ktiles = (nk + kRows - 1) / kRows;",
        "const int ktiles = (nk - 1) / kRows;",
        F32_CASE,
    ),
    "f32_fwd_chunk_acc_not_reset": (  # a stage's P V accumulator starts from the last stage's
        "kernels/csrc/flash_fwd.cu",
        "chunk_3xtf32<D, kRows>(chunk, pa_hi, pa_lo, st + 2 * kRow, st + 3 * kRow);  // P V, B = V^T",
        """for (int kk = 0; kk < kRows / 8; ++kk) {
      WgmmaTf32<D>::rs(chunk, pa_lo[kk], desc_tf32_t<D, kRows>(st + 2 * kRow, kk), 1);
      WgmmaTf32<D>::rs(chunk, pa_hi[kk], desc_tf32_t<D, kRows>(st + 3 * kRow, kk), 1);
      WgmmaTf32<D>::rs(chunk, pa_hi[kk], desc_tf32_t<D, kRows>(st + 2 * kRow, kk), 1);
    }""",
        F32_CASE,
    ),
    "f32_fwd_v_copy_not_permuted": (  # V^T in token order, P's A fragments permuted
        "kernels/csrc/flash_fwd.cu",
        "split_tf32(tile[(pos & ~7) + tf32_token(pos & 7)][c])",
        "split_tf32(tile[pos][c])",
        F32_CASE,
    ),
    "f32_fwd_no_rescale": (  # O is not scaled by alpha when the running max grows
        "kernels/csrc/flash_fwd.cu",
        "o[i] = fmaf(o[i], alpha[(i >> 1) & 1], chunk[i]);",
        "o[i] += chunk[i];",
        F32_CASE,
    ),
    "lnd_dln_drop_last_stage": (  # the dln product's ring skips its last 64-deep stage of F
        "kernels/csrc/ln_dense.cu",
        "const int ksteps = (p.features + T::kStageK - 1) / T::kStageK;",
        "const int ksteps = (p.features - 1) / T::kStageK;",
        LND_CASE,
    ),
    "lnd_dln_b_not_transposed": (  # W's MN-major stage read as K-major
        "kernels/csrc/ln_dense.cu",
        "Wgmma<128>::ss<1>(acc, da, db,",
        "Wgmma<128>::ss<0>(acc, da, db,",
        LND_CASE,
    ),
    "lnd_dln_acc_not_reset": (  # a block's next tile starts from the last tile's sums
        "kernels/csrc/ln_dense.cu",
        "Wgmma<128>::ss<1>(acc, da, db, ks > 0 || kk > 0)",
        "Wgmma<128>::ss<1>(acc, da, db, tile != static_cast<int>(blockIdx.x) || ks > 0 || kk > 0)",
        LND_CASE,
    ),
    "lnd_f32_fwd_tf32_low_terms_dropped": (  # the f32 forward's product in plain TF32: hi * hi alone
        "kernels/csrc/ln_dense.cu",
        """        WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);  // the chunk starts a fresh accumulator
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_lo, 1);
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_hi, 1);""",
        """        if (!kNorm) WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);
        if (!kNorm) WgmmaTf32<128>::rs(acc, cur.hi[kk], b_lo, 1);
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_hi, !kNorm || kk > 0);""",
        LND_F32_CASE,
    ),
    "lnd_f32_dln_tf32_low_terms_dropped": (  # the f32 dln product in plain TF32
        "kernels/csrc/ln_dense.cu",
        """        WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);  // the chunk starts a fresh accumulator
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_lo, 1);
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_hi, 1);""",
        """        if (kNorm) WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);
        if (kNorm) WgmmaTf32<128>::rs(acc, cur.hi[kk], b_lo, 1);
        WgmmaTf32<128>::rs(acc, cur.hi[kk], b_hi, kNorm || kk > 0);""",
        LND_F32_CASE,
    ),
    "lnd_f32_drop_last_chunk": (  # both f32 products skip the last 32-deep chunk of their depth
        "kernels/csrc/ln_dense.cu",
        "const int chunks = (kNorm ? p.cols : p.features) / kTfStageK;",
        "const int chunks = (kNorm ? p.cols : p.features) / kTfStageK - 1;",
        LND_F32_CASE,
    ),
    "lnd_f32_chunk_acc_not_reset": (  # a chunk's accumulator starts from the last one's sums
        "kernels/csrc/ln_dense.cu",
        "WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, kk > 0);",
        "WgmmaTf32<128>::rs(acc, cur.lo[kk], b_hi, 1);",
        LND_F32_CASE,
    ),
    "lnd_f32_split_not_permuted": (  # W's split copies in the original depth order, A's fragments permuted
        "kernels/csrc/ln_dense.cu",
        "const int src = tf32_perm(tx);",
        "const int src = tx;",
        LND_F32_CASE,
    ),
    "ln_rows_no_mean_gxhat": (  # dx = rstd * (g - mean(g)): the mean(g * xhat) term left out
        "kernels/csrc/ln_rows.cuh",
        "g[j][e] - mg - xh[j][e] * mgx",
        "g[j][e] - mg",
        LND_CASE,
    ),
    "fwd_bias_dropped": (  # the bf16 forward's S without the key bias
        "kernels/csrc/flash_fwd.cu",
        "const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);",
        "const float2 bb = make_float2(0.f, 0.f);",
        RING_CASE,
    ),
    "dkdv_bias_dropped": (  # the bf16 dK/dV kernel's S^T without the key bias
        "kernels/csrc/flash_bwd.cu",
        "fmaf(st[4 * j + e], scale2, kb[e >> 1])",
        "fmaf(st[4 * j + e], scale2, 0.f)",
        RING_CASE,
    ),
    "kv_len_as_seq_len": (  # the bf16 forward reads the key count from the query count
        "kernels/csrc/flash_fwd.cu",
        "const int keys = p.kv_len;",
        "const int keys = p.seq_len;",
        SEQ_CASE,
    ),
    "ring_bias_not_rotated": (  # K/V rotate without their bias: pad keys count, valid ones are masked
        "kernels/ring_flash.py",
        "kb, vb, bb = ring_shift((kb, vb, bb), mesh, axis)",
        "kb, vb = ring_shift((kb, vb), mesh, axis)",
        GROUP_CASE,
    ),
    "ring_merge_max": (  # the merge's lse is the larger one, not the log-sum-exp
        "kernels/ring_flash.py",
        "lse_new = torch.logaddexp(lse, lse_s)",
        "lse_new = torch.maximum(lse, lse_s)",
        GROUP_CASE,
    ),
    "ring_bwd_last_partial": (  # the backward takes the last step's partial o and lse, not the merged ones
        "kernels/ring_flash.py",
        "ctx.save_for_backward(q_l, k_l, v_l, bias_l, o_l, lse)",
        "ctx.save_for_backward(q_l, k_l, v_l, bias_l, o_s.to(q.dtype), lse_s)",
        GROUP_CASE,
    ),
    "ring_no_hop_home": (  # dk and dv stay one rank short of their block's home
        "kernels/ring_flash.py",
        "dk, dv = ring_shift((dk, dv), mesh, axis)",
        "dk, dv = dk, dv",
        GROUP_CASE,
    ),
    "int8_no_token_scale": (  # the int8 dequantise drops the per-token activation scale
        "models/quant.py",
        'y = acc.float() * xscale * w["scale"]',
        'y = acc.float() * w["scale"]',
        INT8_CASE,
    ),
    "vgg_tf32": (  # the VGG's f32 convolutions left to cuDNN's default, TF32
        "models/vgg.py",
        "with conv_precision():",
        "with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):",
        PERCEPTUAL_CASE,
    ),
    "accum_sum": (  # the accumulator sums the mini-steps' gradients instead of averaging them
        "train/optim.py",
        "torch._foreach_div_(delta, self.mini_step + 1)",
        "torch._foreach_add_(delta, self.acc)",
        ACCUM_CASE,
    ),
    "seq_dkdv_not_summed": (  # each rank keeps its own rows' share of dk and dv
        "kernels/seq_flash.py",
        "all_reduce_sum(g.float(), mesh, axis)",
        "g.float()",
        GROUP_CASE,
    ),
}


def is_kernel(name: str) -> bool:
    return MUTANTS[name][0].startswith("kernels/csrc/")


def make_copy(name: str, source: str, old: str, new: str) -> Path:
    """The mutant's copy of the port; a schedule mutant's copy keeps the
    checkout's built kernels (its sources are the checkout's)."""
    root = REPO / PKG / "build" / "mutants" / name
    shutil.rmtree(root, ignore_errors=True)
    skip = ("build",) if is_kernel(name) else ("mutants", "stores")
    shutil.copytree(REPO / PKG, root / PKG, ignore=shutil.ignore_patterns(*skip, "__pycache__"))
    for f in ("chip_smoke.py", "pyproject.toml", KERNEL_TESTS):
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / f, root / f)
    broken = root / PKG / source
    src = broken.read_text()
    if old not in src:
        raise SystemExit(f"kernel_mutants: {name}: {old!r} is not in {PKG / source}")
    broken.write_text(src.replace(old, new))
    return root


def run(cmd, cwd: Path, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def check_mutant(name: str, root: Path):
    """The mutant's checks on its copy: -> (caught by all, report line)."""
    main_path = run([sys.executable, "-c", f"import chip_smoke; {MUTANTS[name][3]}"], root, timeout=600)
    reason = (main_path.stderr.strip().splitlines() or ["(no message)"])[-1]
    caught_main = main_path.returncode != 0 and "chip_smoke FAILED" in main_path.stderr
    line = f"main-path shape {'caught' if caught_main else 'MISSED'} ({reason})"
    if not is_kernel(name):
        return caught_main, f"mutant {name}: {line}"
    tests = run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                 "-p", "no:cacheprovider", str(KERNEL_TESTS)], root, timeout=900)
    tally = re.findall(r"(\d+) (failed|passed)", tests.stdout)
    caught_tests = tests.returncode == 1 and any(kind == "failed" for _, kind in tally)
    return caught_tests and caught_main, (
        f"mutant {name}: kernel tests {'caught' if caught_tests else 'MISSED'} "
        f"({', '.join(f'{n} {k}' for n, k in tally) or tests.stdout[-300:]}); {line}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device", file=sys.stderr)
        return 1
    # every kernel mutant's copy and the checkout itself build at once; the
    # schedule mutants' copies then take the checkout's kernels
    roots = {name: make_copy(name, *edit[:3]) for name, edit in MUTANTS.items() if is_kernel(name)}
    builds = {
        name: subprocess.Popen(
            [sys.executable, "-c", "from vit_ae_plus_plus_torch.kernels import _build; _build.build()"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, root in {**roots, "(the checkout)": REPO}.items()
    }
    for name, proc in builds.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_mutants: {name} did not build:\n{log}")
    roots.update({name: make_copy(name, *edit[:3]) for name, edit in MUTANTS.items() if not is_kernel(name)})

    with ThreadPoolExecutor(max_workers=4) as pool:
        checked = dict(zip(roots, pool.map(check_mutant, roots, roots.values())))
    missed = []
    for name, (caught, line) in checked.items():
        print(line, flush=True)
        if not caught:
            missed.append(name)
    shutil.rmtree(REPO / PKG / "build" / "mutants", ignore_errors=True)
    if missed:
        print(f"kernel_mutants: not caught: {missed}", file=sys.stderr)
        return 1
    print(f"kernel_mutants: all {len(MUTANTS)} mutants caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
