#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit when it fails:

1. print the card and build the CUDA kernels from the repository's sources;
2. hold every kernel against its plain PyTorch version on the card at the
   shapes the serving, training and fine-tuning paths give it, on one
   process and on a rank of phase 7d's data-parallel paths (and at the
   shapes of the opt-in `contr_mae_vit_base_patch16_fast` preset's step,
   d = 128: the attention forward in bf16 and f32 and the backward packed
   in bf16 and f32 and per-head in f32, and in f32 one ring block with a
   padded key tail), and time kernel, plain
   version and a PyTorch call the port never uses (a yardstick:
   `scaled_dot_product_attention` by the fastest fused backend that takes
   the inputs, named in the row, forward+backward minus forward for the
   attention backward; `F.layer_norm` + `F.linear` for LayerNorm+Dense,
   `dY @ W` + `native_layer_norm_backward` for its backward; `F.layer_norm`
   and its backward for the LayerNorm kernels), each from a CUDA graph of
   repeated calls timed with CUDA events;
3. build the ViT-B feature engine at full width (96^3, patch 8, batch 8,
   bf16) from seeded numpy weights passed through `params_from_jax`, and
   hold its features to the same weights run with `attn_impl="plain"`;
4. serve it over HTTP on an ephemeral port: a correctness check of the
   main path, not a load test. 24 concurrent `POST /features` requests of
   1-3 volumes from 8 clients, each checked against `engine.infer`, with
   launch counts read around this run (12 packed-kernel launches per slab);
   the request rate and p50 are printed as information only. Then the
   per-head kernel's path (`attn_impl="flash"`) and the f32 path, each with
   counts reset before and read after, the f32 slab's device time and a
   torch.profiler breakdown of it;
   4b. phase 3's slab through `feature_step` on
   `VisionTransformer3D(ln_fusion="on")` with the engine's weights, held
   to the engine's features: 24 LayerNorm+Dense forward launches (12 at
   qkv, 12 at fc1) and 12 packed attention launches, and a profile of it;
   4c. the rest of serving: a bf16 `ClassifierEngine` of 5 folds over
   phase 3's trunk (each fold its own seeded head, fc_norm and last block)
   held to the same weights with attn_impl="plain" and to the mean of the
   five single-fold engines (CLASSIFY_TOL), 60 packed launches a slab;
   `POST /predict` from 4 concurrent clients, each answer against
   `engine.infer`, 60 packed launches a slab; a `.nii.gz` body against
   the `.npy` body of the same volume; a 240x240x155 and a 128^3 request
   resized on the card (`--resize-inputs`), the card's `resize_trilinear`
   against its CPU run; the int8 `FeatureEngine` and `ClassifierEngine`
   against the bf16 ones at the JAX package's bars (cosine, nearest
   neighbour; probabilities within 0.05, same argmax), 12 per-head
   launches a fold and slab; each path's device ms per slab printed
   beside bf16 features, and a profile of the int8 feature slab;
   4d. the engine artifacts (serving_aot.py): `save_engine` then
   `load_engine` of phase 3's bf16 feature engine and 4c's int8 feature
   engine and classifier, each load and its first slab with an empty
   kernel build directory: no nvcc run, the loaded slab equal to the built
   engine's bitwise, the same launches; each artifact's MB, save seconds
   and seconds from the load to the first answer printed beside the
   seconds of building and warming the engine;
5. the full-width MAE pretraining step (96^3, patch 8, batch 8, bf16,
   ViT-B encoder over 2B = 16 masked views, 8-block decoder, composite loss,
   AdamW) from seeded numpy weights and batch statistics through
   `params_from_jax`, with injected masking noise: three steps with
   attn_impl="auto" (the packed kernels) against three with "plain" from the
   same start (losses, metrics and three gradients), launch counts read
   around every step (20 packed forward and 20 packed backward: 12 at the
   encoder's shape, 8 at the decoder's), then one step with
   attn_impl="flash" (the per-head kernels), one f32 step against f32
   plain and one f32 step with attn_impl="flash" against it (the per-head
   f32 backward's path), then one f32 step of the `_fast` preset (d = 128
   heads, phase 5's weights and noise) against its f32 plain step (20
   packed forward and 20 packed backward launches at d = 128: 12 at the
   encoder's B16 H6 N433, 8 at the decoder's B8 H4 N1729), its device time
   and profile; step time, volumes/s, peak memory and a
   torch.profiler breakdown of one step's device time as information;
   5b. three bf16 steps with `ln_fusion="on"` against three with "off"
   from the same weights and noise (losses, metrics, five gradients), counts
   read around every step (40 LayerNorm+Dense forward and 40 backward: 12
   and 12 at the encoder's qkv and fc1 shapes, 8 and 8 at the decoder's,
   beside the 20 + 20 attention launches), one f32 step against f32 "off",
   then the fused step's time, peak memory and profile, and the f32 fused
   and unfused steps' times and profiles; and one forward and
   backward of `FusedLayerNorm` at the encoder's norm shape, the path of
   the LayerNorm kernels;
   5c. the host data path feeds the step: 48 seeded 96^3 volumes written
   to a temporary directory and split by the port's `prepare-data brats`
   (file names and shapes checked, x_whole against the input), then
   `get_dataset` with the native augmenter (`native="require"`) ->
   `Loader` (batch 8, 8 threads) -> `cuda_prefetch(size=2)` -> phase 5's
   step, one warm-up and 5 timed steps in f32 and in bf16, each against
   the resident-views step on the same trainer; the first batch on the
   card must be its numpy batch bitwise, the staging buffers pinned, every
   metric finite and each step's attention launches phase 5's; prints the
   step times, the collate, queue-wait and H2D times and the device's idle
   share of a loader-fed step;
   5d. the port's `pretrain-kfold` command on 5c's split directory, in f32
   and in its default bf16: 2 folds, 3 epochs of 3 steps at batch 8, then
   3 extraction slabs each of a fold's 24 train and 24 test volumes. Exit
   0, the fold index files, 6 finite `log.txt` rows, each fold's min-loss
   `.pth` through `load_reference_state_dict`, (24, 768) f32 features with
   their labels, the attention launches by shape (18 steps of phase 5's
   plus 12 slabs of 12), and fold 0's test features against the same
   `.pth` run with attn_impl="plain"; prints each epoch's ms per step and
   volumes/s beside 5c's step times, the `.pth` writes, extraction ms per
   slab and each fold's wall time; the bf16 run also profiles epoch 1 of
   each fold and writes its resume files at epoch 2 (for phase 5j);
   5e. the port's downstream commands on 5d's bf16 work dir and 5c's
   split, at batch 8: `extract-features` from fold 0's `.pth` (the files,
   and the test features against the same `.pth` run with
   attn_impl="plain"), `probe-kfold` and `finetune-kfold` in bf16 (2 folds
   of 2 epochs) and `finetune` in f32 (2 epochs): exit 0, the best-model
   `.pth` files, test stats finite in [0, 1], the attention launches by
   shape (12 packed forward a step or evaluation slab, 12 packed backward
   a fine-tune step, none for the probe); then one full-width fine-tune
   step (the classifier ViT at B8 H12 N1729 d64) with the kernels against
   attn_impl="plain" in bf16 and f32 (loss and four gradients within
   STEP_TOL) and one with "flash"; prints each command's wall time, ms per
   fine-tune and probe step, evaluation ms per slab and peak memory;
   5f. the supervised 3D ResNet and the classical evaluation: ResNet-10 at
   full width (widths 64-512) on 96^3, one f32 step on the card against the
   same step on the CPU (loss, every gradient, every BatchNorm buffer
   within RESNET_TOL), the same card step with TF32 allowed, which must miss
   that gate, and one bf16 step against the same step with plain
   convolutions (f32 sums of bf16-rounded operands), which the f32 step and
   wrong class weights must miss; the step's ms,
   volumes/s, evaluation ms per slab, peak memory and profile at batch 8;
   then `resnet-kfold` through the CLI on 5c's split (2 folds x 2 epochs at
   batch 8, bf16 and f32; no custom kernel launched, 4 finite log rows,
   each fold's best `.pth` loads into `ResNet3D`, `--eval-only` reads each
   best ROC back bitwise), its wall time by span; and `eval-classical` on
   5d's bf16 features, twice with `--method svm` (the port's copy of
   scikit-learn's libsvm, built with g++), twice with `--method linear`
   (its copies of liblinear, SAG and the logistic loss) and twice with
   `--method rf` (its copy of the tree builder): the summary's keys, AUCs
   finite in [0, 1], the second run equal; for linear and rf each fold's
   refitted search gives the command's AUC; lbfgs and newton-cg on fold 0
   converge and agree within LINEAR_GATE, which lbfgs at max_iter=1 must
   miss; the forest equals scikit-learn 1.9.0's RF_REFERENCE bit for bit
   (trees and probabilities), which its control at random_state=43 must
   miss; with the build and wall times, each fold's best_params_, the
   trees grown and the microseconds a tree, and the card's scipy and numpy
   versions;
   5g. the MoCo-v3 baseline: the full-width MoCo-ViT step (ViT-B at 96^3 /
   patch 8, every token, heads 4096 / 256, LARS) from seeded numpy
   weights and batch statistics through `params_from_jax`, the momentum
   encoder a copy of the base as `moco-kfold` starts it, one step of 8 with
   the kernels against one with attn_impl="plain": in f32 the loss, the
   momentum leaves after the EMA and the running statistics within
   STEP_TOL, three gradients within STEP_TOL or four times the plain
   step's own movement on its views nudged by one part in 2^20 (the
   floor), which the plain step with TF32 products must miss; in bf16 the
   same readings as information only (bf16 rounding alone moves them as
   far as the kernels do, `moco_step_conditioning.py`); the launches
   around the step (48 packed forward and 24 packed backward at
   B8 H12 N1729 d64, reported in the kernel rows' `moco_launches`), its
   ms, volumes/s, peak memory and profile; then `moco-kfold` through the CLI on 5c's split (2 folds x 2
   epochs at batch 8, bf16 and f32: exit 0, finite log rows, each fold's
   min-loss `.pth` loads into `MoCoViT3D`, (24, 768) features with their
   labels, the attention launches by shape, fold 0's test features
   against the same `.pth` with attn_impl="plain"), `moco-extract` on the
   bf16 work dir (its files equal `moco-kfold`'s bitwise) and
   `moco-kfold --moco-arch resnet` in bf16 (2 folds x 1 epoch, no custom
   kernel launched, (24, 512) features), each with its wall time by span;
   last, one f32 MoCo-ResNet-10 step of 8 and its floor, the reference of
   7d (e);
   5h. `contrastive-train`: the full-width contrastive step (ViT-B at
   96^3 / patch 8, global pooling, the predictor; batch 8, every volume
   its own intensity offset, see `contrastive_views`) with the kernels
   against attn_impl="plain": in f32 the loss, four gradients and the
   predictor's running statistics within STEP_TOL; in bf16 the statistics
   within STEP_TOL, the loss and the gradients within STEP_TOL or four
   times the plain step's floor (bf16 rounding alone moves those gradients
   past STEP_TOL); 24 packed
   forward and 24 packed backward launches at B8 H12 N1729 d64 a step
   (the kernel rows' `contrastive_launches`), ms per step, volumes/s and
   peak memory; then the command on 5c's split, 2 epochs of 6 steps in
   bf16, without and with `--use-proj` (exit 0, 2 finite `log.txt` rows,
   the `.pth` loads, the launches by shape), its wall time by span;
   5i. the pretraining options off the default path: (a)
   `device_augment_batch` on seeded raw batches of 8 at 96^3, BraTS (one
   channel) and EGD (four, per-channel z-score), shear and gather, on the
   card against its CPU run with the same draws on the first volumes
   (AUG_TOL), ms per batch; (b) 5c's raw volumes resident on the card
   (`DeviceResidentBatches`: one epoch's batches `Loader`'s, bitwise)
   feeding phase 5's f32 and bf16 steps through the augmentation (phase
   5's launches each step), ms per step, volumes/s and idle beside 5c's
   steps; (c) phase 5's f32 step with the VGG16 term at
   PERCEPTUAL_WEIGHT (seeded weights): the logged term, the term against
   the VGG in f64 (PERCEPTUAL_TOL), a TF32 control that must miss, the
   gradients against the term-free step's, ms and peak memory with and
   without it; (c') `perceptual_differentiable=True` on the f32 model at
   PERCEPTUAL_GRAD_BATCH volumes: the through pass's gradients minus the
   term-free pass's against the term's own gradient (STEP_TOL), which the
   default mode must miss, ms and peak memory of each pass; (d)
   `accum_iter=2` on the f32 step: mini-step 1 leaves the
   parameters bitwise, mini-step 2 makes one AdamW update on the mean of
   the two gradients (moves and first moments within STEP_TOL), a
   summing control that must miss; (e) `pretrain-kfold --device-data
   --perceptual-weight` (2 folds x 1 epoch x 3 steps, bf16, accum_iter 2
   on the CLI's TrainConfig): exit 0, the resident lines, finite log rows
   with the term, the `.pth` files, the features, the launches by shape;
   5j. the tooling on 5d's bf16 work dir (whose run profiles one epoch a
   fold with `--profile-dir` and writes resume files with `--resume
   --ckpt-every 3`): `profile-attrib --json` on the newest trace (the
   buckets against the device events recounted from the trace, the
   attention bucket `flash_*` only, its kernels a step the packed
   wrappers' launches times KERNELS_PER_LAUNCH; the table printed);
   `doctor` (exit 0, no FAIL, its seconds); `export-torch` of fold 0's
   resume directory (loads strictly into the MAE, equal to the payload's
   model bitwise) and of its `checkpoint.pth` through `file://` and
   `http://` from a local server (equal bitwise); `sanity_viz.reconstruct`
   in bf16 from fold 0's `.pth` on 2 test volumes against the same weights
   and noise with attn_impl="plain" (ENGINE_TOL), 12 + 8 packed launches a
   volume at the B1 shapes phase 2 holds, finite fractions, `save_nifti`
   read back; the `sanity-viz` command (exit 0 and its PNGs with
   matplotlib, exit 2 naming it before any model build without); the
   reference-faithful f32 step of FAITHFUL_BATCH from phase 5's weights,
   views and noise against the port's plain f32 step (STEP_TOL; the
   perceptual metric, which the port's step leaves at 0, finite), its ms
   with a sync a step, its peak, `flagship_step_flops` and phase 5c's
   bf16 step's MFU;
6. the ring's partial kernels (csrc/flash_fwd.cu and flash_bwd.cu with a
   key bias) against their plain versions at the ring blocks of the paths
   in phase 7, each the block that holds the padded tail, bf16 and, at
   the f32 step's decoder and encoder blocks, f32, and at a fully
   padded block (correctness only); the per-head kernels with 1,032 query
   rows against 4,097 keys (the sequence-sharded shard); library times
   from `scaled_dot_product_attention` with the bias as a float mask, the
   fastest fused backend that takes it named;
   6b. with `--parent DIR` (a checkout of another commit), the f32
   attention forward and backward rows of the training step (its encoder
   and decoder shapes and the `_fast` preset's two d = 128 shapes, packed
   and per-head) and the forward at the f32 slab's shape timed in turns
   against DIR's bodies: each checkout's own case functions in a process
   of its own, parent, this checkout, this checkout, parent; the rows'
   `in_turns` hold the four times (null without `--parent`; the per-head
   forward rows, which phase 2 has not, are printed with SDPA's time and
   the bound); each turn also times the f32 slab (and its peak allocation)
   and the f32 step (TrainConfig's default dtype), unfused and with
   `ln_fusion="on"`, and the `_fast` preset's f32 step, with their peaks;
7. a world of 4 spawned ranks on the one card, in one gloo group (NCCL
   takes one rank per device; the kernels stay on the card and the blocks
   travel through pinned host memory), every join bounded: ring and
   sequence-sharded attention at B=2, H=12, N=4,097 against
   `flash_attention`; ViT-B `forward_features` at 128^3 / patch 8 (4,097
   tokens), batch 2, with `attn_impl="flash_ring"` and `"flash_seq"`
   against `"flash"` (48 ring forward launches a rank: 12 blocks x 4
   steps); then three bf16 MAE steps at phase 5's size with "flash_ring",
   step 1 against phase 5's default step (80 ring forward and 80 ring
   backward launches a rank and step: 48 in the encoder, 32 in the
   decoder), and the parameters after the steps, which must be bitwise
   equal on every rank (the replicated trunk is right only while they are);
   then one f32 MAE step with "flash_ring" (the f32 ring kernels), held
   against phase 5's f32 step within STEP_TOL["float32"], its parameters
   bitwise equal on every rank after it; every shape a step launches a
   ring kernel at has a phase 6 row;
   7d. data parallelism over the same ranks, a (4, 1) mesh, every rank on
   its rows of the global batch of 8: three f32 and three bf16 MAE steps
   from phase 5's weights, views and noise, step 1 against phase 5's
   one-process step within STEP_TOL (loss terms, GRAD_NAMES gradients,
   BatchNorm statistics), the parameters bitwise equal on every rank after
   the steps, the launches of every step at the per-rank shapes; a control
   with the BatchNorm moments left local, which must fail the f32 gate;
   three bf16 steps on a (2, 1) mesh of the first two ranks, held the same
   way; one f32 fine-tune step with timm's mixup from 5d's fold-0 `.pth`
   against the one-process step; `pretrain_kfold` (5c's split, fold 0, one
   epoch of 3 steps without warmup, bf16) against the same run in one
   process at 4 x blr (the ranks' rate counts the global batch 4 times, as
   the JAX package's does; `log.txt`'s train_lr equal), (one `.pth`, one
   `log.txt`, the one-process run's files, the
   epoch's train_loss within DDP_LOSS_TOL, the features within
   ENGINE_TOL), and a control with the gradients left unaveraged, whose
   train_loss must miss that limit; `extract_ssl_features` from 5d's
   `.pth` against phase 5e's `extract-features` files within ENGINE_TOL, in the same order; every
   per-rank shape has a phase 2 row. Prints, beside the card, each rank's
   step wall times, host-staged bytes, the gradient all-reduce's time
   alone and peak memory, and the one-process step's wall times;
   (e) the MoCo step over the same ranks (MOCO_DDP_RUNS): the ViT at
   (4, 1) and (2, 1) in f32 and bf16 and the ResNet-10 at both in f32,
   one step each from phase 5g's weights and views (every rank waits
   for the others before each), against 5g's
   one-process step (f32 within 5g's limits, bf16 printed only), the
   parameters bitwise equal on every rank, the launches; two controls
   that must miss, each rank's queries against its own keys (the loss)
   and BatchNorm moments left local (the predictor's running variance);
   then `moco_kfold` (f32, fold 0's first 16 training volumes: 2 epochs
   of 2 steps, no warmup) against the same run in one process: the same
   files, `log.txt`'s train_loss and the features within DDP_LOSS_TOL and
   ENGINE_TOL or four times their floor (one process on its volumes
   scaled by 1 + 2^-20: f32 MoCo training carries rounding that far in a
   few steps; a floor above MOCO_KFOLD_FLOOR_CEIL fails), and a control
   with the gradients unaveraged that must miss;
   (f) the f32 contrastive step of 5h on (4, 1) against 5h's one-process
   step within STEP_TOL, the parameters bitwise equal, the launches, and a
   local-moments control that must miss on the predictor's statistics.
   Prints each rank's step wall times, host stagings (count and bytes),
   the gradient all-reduce alone and peak memory;
   7e. the sharded training state over the same ranks (SHARDED_RUNS), one
   step each from phase 5's weights, views and noise on each data
   coordinate's rows: FSDP (parallel/fsdp.py) on (4, 1) in f32 and bf16,
   TP (parallel/tp.py, attn_impl='flash') on (1, 2) in f32 and bf16 and on
   (2, 2) in bf16, and the 'flash_ring' step on (2, 2), each against phase
   5's one-process step within STEP_TOL (the gradients gathered whole);
   then the MoCo ViT FSDP step on (4, 1) in f32 against 5g's step within
   its limits. The whole parameters bitwise equal on every rank after the
   step, the launches (under FSDP a block's forward runs again in the
   backward), a TP rank's qkv block (3C / M, C), an FSDP rank's resident
   parameters below 0.3 of the replicated ones; every per-rank shape has
   a phase 2 or phase 6 row. Prints each rank's resident parameter and
   optimizer bytes beside the replicated figure, peak memory, host-staged
   bytes and step wall time, and the phase's seconds;
   7f. the GPipe pipeline (PIPE_RUNS, `check_pipe`);
   7g. the serving mesh over the same ranks: phase 4c's bf16 and int8
   feature engines and 5-fold classifier on a (4, 1) mesh, rank 0
   answering phase 4c's slab (each rank runs its 2 rows) against the
   one-process engines within ENGINE_TOL / CLASSIFY_TOL, every rank's
   launches of one slab, each rank's device ms per slab and host-staged
   bytes printed;
   7h. on a (2, 2) mesh of the same ranks, one f32 step each of MoCo-ViT,
   MoCo-ResNet and the contrastive model against phases 5g's and 5h's
   one-process steps under their f32 gates, the parameters equal on all 4
   ranks (one digest), the launches of each rank;
8. print one JSON line of kernels, the card's name and power limit, and as
   the last line `{"ok": true, "device": {...}}`. Each kernel row names
   the CUDA bodies it launched (`body`). Each kernel row's
   `launches` is what its wrapper launched at the row's shape and dtype in
   the first path run that launched it there (the wrappers count by shape;
   in phase 7, rank 0's count), and `path` names that run; a reference case
   that no path runs at its shape reads 0.

Every kernel check synchronises first, so that a kernel that faults fails
its own check. Without a CUDA device, or outside a checkout, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import dataclasses
import functools
import gc
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MODEL = "contr_mae_vit_base_patch16"
# the opt-in preset of d = 128 heads (6 in the encoder, 4 in the decoder) at
# MODEL's parameter shapes: phase 5's weights load into it
FAST_MODEL = "contr_mae_vit_base_patch16_fast"
FAST_ENC, FAST_DEC = (16, 6, 433, 128), (8, 4, 1729, 128)  # its step's attention shapes (B, H, N, d)
VOLUME, PATCH, BATCH = 96, 8, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# dense tensor-core rates of an H100 SXM (NVIDIA data sheet). f32-accurate
# products run on the TF32 tensor cores as 3xTF32 (three TF32 products per
# f32 one, as the f32 attention forward does), so the least time for f32
# matrix work is at 495 / 3 TFLOP/s, above the 67 of f32 without tensor
# cores: a bound that no f32 kernel can beat, whatever it runs on
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
F32_SIMT_FLOPS = 67e12  # f32 elementwise work (the LayerNorm rows), without tensor cores
# exponentials a second: the SFU's 16 a clock and SM, about 3.9e12 on an
# H100 SXM against its 989 TFLOP/s of bf16 (FlashAttention-3, Shah et al.
# 2024, section 3.1); attention's softmax takes one a score
EXP_PER_S = 3.9e12
KERNEL_SOURCE = "vit_ae_plus_plus_torch/kernels/csrc/flash_fwd.cu"
BWD_SOURCE = "vit_ae_plus_plus_torch/kernels/csrc/flash_bwd.cu"
REPLACES = {
    "packed": "vit_ae_plus_plus_tpu/kernels/packed_flash.py:164",
    "per_head": "vit_ae_plus_plus_tpu/kernels/pallas_flash.py:446",
}
BWD_REPLACES = {
    "packed": "vit_ae_plus_plus_tpu/kernels/packed_flash.py:196",
    "per_head": "vit_ae_plus_plus_tpu/kernels/pallas_flash.py:531",
}
RING_REPLACES = {"fwd": "vit_ae_plus_plus_tpu/kernels/ring_flash.py:154",
                 "bwd": "vit_ae_plus_plus_tpu/kernels/ring_flash.py:181"}
LN_SOURCES = {  # kernel row -> (source, the TPU kernel it replaces)
    "layernorm_fwd": ("vit_ae_plus_plus_torch/kernels/csrc/layernorm.cu",
                      "vit_ae_plus_plus_tpu/kernels/fused_ln.py:153"),
    "layernorm_bwd": ("vit_ae_plus_plus_torch/kernels/csrc/layernorm.cu",
                      "vit_ae_plus_plus_tpu/kernels/fused_ln.py:190"),
    "ln_dense_fwd": ("vit_ae_plus_plus_torch/kernels/csrc/ln_dense.cu",
                     "vit_ae_plus_plus_tpu/kernels/fused_ln_dense.py:119"),
    "ln_dense_bwd": ("vit_ae_plus_plus_torch/kernels/csrc/ln_dense.cu",
                     "vit_ae_plus_plus_tpu/kernels/fused_ln_dense.py:159"),
}
BODIES = {  # (kernel row or attention direction, dtype) -> the CUDA bodies it launches
    ("fwd", "bfloat16"): "flash_fwd_wgmma_kernel (wgmma + TMA)",
    ("fwd", "float32"): "flash_fwd_split_kernel + flash_fwd_tf32_kernel (3xTF32 on tf32 wgmma + TMA)",
    ("bwd", "bfloat16"): "flash_bwd_delta_kernel + flash_bwd_dkdv_wgmma_kernel + flash_bwd_dq_wgmma_kernel "
                         "(wgmma + TMA)",
    ("bwd", "float32"): "flash_bwd_delta_kernel + flash_bwd_split_kernel + flash_bwd_dkdv_tf32_kernel + "
                        "flash_bwd_dq_tf32_kernel (3xTF32 on wgmma + TMA; at d = 128 the dK/dV kernel runs as "
                        "two, flash_bwd_dkdv_tf32_kernel<128, .., DK=false, DV=true> and <.., DK=true, "
                        "DV=false>)",
    ("layernorm_fwd", "bfloat16"): "vitae_ln_fwd_kernel",
    ("layernorm_bwd", "bfloat16"): "vitae_ln_rows_bwd_kernel",
    ("ln_dense_fwd", "bfloat16"): "vitae_lnd_fwd_bf16_kernel (wgmma + TMA)",
    ("ln_dense_fwd", "float32"): "vitae_lnd_stats_f32_kernel + vitae_tf32_split_kernel + vitae_lnd_tf32_kernel "
                                 "(3xTF32 on wgmma + TMA)",
    ("ln_dense_bwd", "bfloat16"): "vitae_lnd_dln_wgmma_kernel (wgmma + TMA) + vitae_ln_rows_bwd_kernel",
    ("ln_dense_bwd", "float32"): "vitae_tf32_split_kernel (W transposed) + vitae_lnd_tf32_kernel (3xTF32 on wgmma "
                                 "+ TMA) + vitae_ln_rows_bwd_kernel",
}
# kernel vs plain version: `kernel_tolerance` (kernels/flash_attention.py),
# two bf16 spacings at the largest output in bf16, 1e-5 in f32, 1e-4 on lse.
# Engine features vs the same weights with attn_impl="plain", as max abs
# error over the largest feature magnitude: in f32 only summation order
# differs (an H100 reads about 2.4e-7); in bf16 the kernel's bf16 P and the
# plain version's f32 P round differently through 12 blocks (about 5e-3)
ENGINE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a served volume vs the same volume through engine.infer: the same
# computation on a slab of the same shape (rows are independent), so any
# difference beyond noise means a volume was mixed up or mis-padded
SERVED_TOL = 1e-3
# the training step with the kernels vs the same weights, data and noise with
# attn_impl="plain", step 1, as max abs difference over the largest
# magnitude. bf16: the kernels round P (and dS) to bf16 where the plain
# version keeps f32, through 12 encoder and 8 decoder blocks forward and
# back. An H100 reads at most 2.2e-4 on the loss terms (contr_loss, a term
# of about 1.6e-5; the others read 2e-6 to 7e-6) and 5.8e-3 on the three
# gradients, the same on the packed and the per-head path: the limits are
# about four times those. f32: only summation order differs; an H100 reads
# at most 1.2e-7 on the loss terms and 5.7e-7 on the gradients.
STEP_TOL = {"bfloat16": {"loss": 1e-3, "grad": 2e-2}, "float32": {"loss": 1e-5, "grad": 1e-5}}
# phase 7d (c): the 4-rank bf16 `pretrain_kfold`'s epoch loss (log.txt's
# train_loss, the mean of 3 steps) against one process's, relative. The two
# runs make the same products on the same rows and sum the gradients in
# another order: an H100 reads 8.2e-7 (and 1.9e-6 on 7d (a)'s bf16 losses at
# steps 2-3). Ranks that each step on their own gradients read 1.3e-4, inside
# STEP_TOL["bfloat16"]["loss"]; this limit is about ten times the run's
# largest reading and a sixth of that control's.
DDP_LOSS_TOL = 2e-5
# phase 7d (e): `moco_kfold`'s floor, one process against itself on its
# volumes scaled by 1 + 2^-20 (log.txt's train_loss, relative; the
# features, the largest error over the largest magnitude). f32 MoCo
# training carries rounding far in 4 LARS steps: an H100 reads 1.7e-4 and
# 1.6e-2, so the 4-rank run is held to four times the floor, and a floor
# above these ceilings (about three and two times those readings) fails
# rather than widening the limits. The unaveraged control reads 1.2e-2 on
# the loss, six times the largest limit the ceiling allows.
MOCO_KFOLD_FLOOR_CEIL = {"loss": 5e-4, "features": 3e-2}
# the bf16 step with ln_fusion="on" vs "off", by the same measure: the fused
# trunk rounds every qkv and fc1 output in another place (the bias added
# after rounding) and keeps dln in f32. An H100 reads 2.7e-3 on contr_loss
# (the same near-zero term), 1.2e-4 to 3.1e-4 on the others, and 6.4e-3 on
# the five gradients: the limits are about four and three times the
# largest. In f32 the two trunks differ in summation order only, and are
# held to STEP_TOL["float32"].
FUSED_STEP_TOL = {"loss": 1e-2, "grad": 2e-2}
GRAD_NAMES = ("blocks.0.attn.qkv.weight", "decoder_blocks.0.attn.qkv.weight", "patch_embed.proj.weight")
# and with ln_fusion="on", two that only the fused backward produces there
FUSED_GRAD_NAMES = GRAD_NAMES + ("blocks.0.norm1.weight", "blocks.0.mlp.fc1.weight")
# ring and sequence-sharded attention at N4097 against the single-device
# kernel on the same bf16 inputs, in bf16 spacings at the largest magnitude
# of each single-device result: both round o, P and dS to bf16, the ring
# also rounds each of its four partial outputs (and each step's gradients)
# to bf16 before its f32 merge (or sum), as the JAX package does, and the
# sequence-sharded path its four partial dk and dv. An H100 reads one
# spacing on o and on the gradients of either path (flash_seq's o and dq
# bitwise equal); the limits are two and four. A broken schedule reads far
# more: kernel_mutants.py's schedule mutants run this check.
SHARDED_SPACINGS = {"o": 2, "grad": 4}
TRAIN_STEPS = 3
DDP_STEPS = 2  # phase 7d (a)'s steps a run: two show the ranks stay equal after an update
TIMED_STEPS = 5
GROUP_RANKS = 4  # the 'model' group of phase 7, all on the one card
GROUP_VOLUME = 128  # 128^3 / patch 8: 4,097 tokens, a length the sequence-parallel paths exist for
GROUP_TIMEOUT = 600.0  # seconds for the whole of phase 7, spawn and joins included
# the fine-tune step's gradients held to STEP_TOL: the last block's and the
# first block's qkv (after one attention backward, and after all twelve),
# the patch embed's and the head's. The gated step's batch is of one class:
# with both classes the gradient into the trunk is a difference between the
# classes' samples, sum_i (p_i - y_i) J_i^T v with p near 0.5 (the head
# starts at 2e-5), which cancels over nearly equal random volumes and
# magnifies rounding of either kind. An H100 read, with four of each class,
# 1.07e-5 in f32 and 1.5e-2 in bf16 on blocks.11's qkv and 3.8e-2 in bf16
# on the head. That balanced step is printed as information beside the same
# plain step run on the batch reversed (the same arithmetic summed in
# another order), which reads the cancellation alone.
FT_GRAD_NAMES = ("blocks.11.attn.qkv.weight", "blocks.0.attn.qkv.weight", "patch_embed.proj.weight",
                 "head.weight")
FT_METRICS = ("roc_auc_score", "specificity", "sensitivity")
# phase 5f's ResNet-10 step gates, by `resnet_errs`: the loss over its
# magnitude; each gradient's and each BatchNorm buffer's largest error over
# its largest magnitude, the worst tensor ("grads", "buffers") and the
# median one ("grads_median"). f32 on the card (cuDNN, TF32 off) against
# f32 on the CPU (oneDNN) differ in summation order only, but a 3D conv's
# weight gradient sums millions of products that train-mode BatchNorm's
# backward has made cancel: the CPU's own f32 step reads up to 3e-2 on
# layer3.0.conv1's gradient against its f64 step (printed beside the
# gates). An H100 read loss 9.4e-8, grads 7.6e-3 (median 7.8e-4), buffers
# 8.1e-7; with TF32 allowed, loss 1.8e-5, grads 0.17 (median 7.6e-2),
# buffers 3.7e-4. The limits are about four times the f32 readings. bf16:
# against the same step with plain convolutions (f32 sums of bf16-rounded
# operands, rounded outputs: the same rounding points), whose sums run in
# another order and flip a few bf16 roundings, which train-mode BatchNorm
# carries far. Each limit sits between the floor (the plain step on the
# input scaled by 1 + 2^-20) and the nearest control that must miss; an
# H100 read, bf16 / floor / control: loss 2.8e-4 / 5.4e-4 / 3.3e-3 (the
# f32 step), buffers 1.2e-3 / 1.4e-3 / 6.2e-3 (f32), worst gradient 0.28 /
# 0.24 / 1.6 (class weights 1, 1), median gradient 0.13 / 0.17 / 0.37
# (class weights); a single gradient at half its size reads 0.5 and misses.
# BatchNorm's output rounded to bf16 reads as the floor does here (loss
# 5.5e-4, median 0.20) and is held on the CPU instead
# (tests/test_torch_port_resnet.py, where few roundings flip)
RESNET_TOL = {"float32": {"loss": 4e-7, "grads": 3e-2, "grads_median": 3e-3, "buffers": 4e-6},
              "bfloat16": {"loss": 1.5e-3, "grads": 0.45, "grads_median": 0.3, "buffers": 3e-3}}
# phase 5c's synthetic BraTS input: 48 single-channel 96^3 f32 volumes
# (170 MB, six batches of 8 an epoch), balanced labels
DATA_VOLUMES, DATA_SEED = 48, 51

def stop(proc) -> None:
    """End a child process that is still running (at exit, failed or not)."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def synced(label: str) -> None:
    """Wait for the card: a kernel that faulted (an illegal address, a
    trapped barrier wait) fails its check here, before any other call
    reports the fault as its own."""
    import torch

    try:
        torch.cuda.synchronize()
    except RuntimeError as err:
        check(False, f"{label}: the kernel faulted ({str(err).splitlines()[0]})")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of `fn` over `reps` back-to-back calls, by CUDA events: for
    a whole forward pass, long next to the host's time to launch it (single
    kernels take `graph_ms`)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 5, cold: bool = False) -> float:
    """Device time of one call of `fn`: `calls` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events. A short kernel runs
    for less time than its wrapper's Python and ctypes call take on the host,
    so back-to-back calls would time the host; the graph replays the
    launches alone. Warm-up and capture run on one side stream.

    `cold`: each call follows a write of 128 MB, so that the operands come
    from device memory and not from the 50 MB L2 cache, as in the training
    step; the time of the writes alone, from a graph of their own, is taken
    off."""
    import torch

    scratch = torch.empty(2**25, dtype=torch.float32, device="cuda") if cold else None

    def timed(body) -> float:
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            for _ in range(2):
                body()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(calls):
                body()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * calls)

    if not cold:
        return timed(fn)
    both = timed(lambda: (scratch.zero_(), fn()))
    return both - timed(scratch.zero_)


def bound(b: int, h: int, n: int, d: int, dtype: str, elt: int, nk: int = None, bwd: bool = False,
          extra_bytes: int = 0):
    """Least time the card could take for attention of n query rows against
    nk keys (default n), the largest of three times. Bytes: forward, q, k, v
    read once and o written once; backward, q, k, v, o and do read once and
    dq, dk and dv written once; plus `extra_bytes` (an f32 lse, a key bias).
    Products: 4*B*H*N*NK*d forward, 10*B*H*N*NK*d backward (five N x NK x d
    products), at the type's peak. Forward, also the exponentials: one a
    score, B*H*N*NK, at EXP_PER_S. -> (ms, "bytes" or "operations", which
    limit: "bytes", "products" or "exp")."""
    nk = n if nk is None else nk
    times = {
        "bytes": ((2 * n + 2 * nk) * b * h * d * elt * (2 if bwd else 1) + extra_bytes) / HBM_BYTES_PER_S,
        "products": (10 if bwd else 4) * b * h * n * nk * d / PEAK_FLOPS[dtype],
        "exp": 0.0 if bwd else b * h * n * nk / EXP_PER_S,
    }
    limit = max(times, key=times.get)
    return times[limit] * 1e3, ("bytes" if limit == "bytes" else "operations"), limit


def sdpa_calls(heads, scale, mask=None) -> dict:
    """`scaled_dot_product_attention` of q, k, v = heads(), the yardstick of
    the attention rows, under each fused backend that takes these inputs
    forward and backward (the flash backend refuses a float mask; the math
    backend, the plain version's method, is left out): {backend: call}.
    `heads` runs inside every call, so that a backward's autograd graph is
    built on the stream a CUDA graph captures."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    calls = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(*heads(), attn_mask=mask, scale=scale)
        try:
            with warnings.catch_warnings():  # a refusing backend warns before it raises
                warnings.simplefilter("ignore")
                out = call()
                if out.requires_grad:
                    out.float().sum().backward()
        except RuntimeError:
            continue
        calls[backend.name] = call
    check(bool(calls), "no fused SDPA backend takes these inputs")
    return calls


def sdpa_fwd_ms(calls: dict) -> tuple:
    """The fastest backend's forward: -> (ms, backend)."""
    import torch

    with torch.no_grad():
        times = {name: graph_ms(call) for name, call in calls.items()}
    best = min(times, key=times.get)
    return times[best], best


def sdpa_bwd_ms(calls: dict, leaves, do) -> tuple:
    """The fastest backend's backward, forward+backward minus forward from
    `leaves`: -> (ms, backend)."""
    import torch

    times = {name: graph_ms(lambda: torch.autograd.grad(call(), leaves, do)) - graph_ms(lambda: call().detach())
             for name, call in calls.items()}
    best = min(times, key=times.get)
    return times[best], best


def fwd_row(label, row, got, want, times, bnd, lse_relative=False) -> dict:
    """Check a forward kernel's (o, lse) against its plain version's and
    print; -> its kernel row: `row` (name, replaces, shape, dtype, key) with
    the errors, `times` (kernel, plain and SDPA ms, SDPA's backend) and the
    bound `bnd`. The lse is held to `kernel_tolerance`'s 1e-4, or with
    `lse_relative` (a fully padded block's, about -1e30 on both sides) to
    1e-6 of its magnitude."""
    import torch

    from vit_ae_plus_plus_torch.kernels import kernel_tolerance

    (o, lse), (want_o, want_lse) = got, want
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    err = (o.float() - want_o.float()).abs().max().item()
    tol, lse_tol = kernel_tolerance(want_o)
    lse_err = (lse - want_lse).abs().max().item()
    if lse_relative:
        lse_err, lse_tol = lse_err / want_lse.abs().max().item(), 1e-6
    check(err <= tol and lse_err <= lse_tol,
          f"{label}: max abs err {err:.3g} (tol {tol:.3g}), lse {lse_err:.3g} (tol {lse_tol:.3g})")
    (ms, plain_ms, library_ms, backend), (bound_ms, bound_by, limit) = times, bnd
    print(f"kernel {label}: max_abs_err {err:.3g} (tol {tol:.3g}), lse {lse_err:.3g} (tol {lse_tol:.3g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({backend}) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {limit})", flush=True)
    return {"launches": None, **row, "route": "cuda", "source": KERNEL_SOURCE,
            "body": BODIES[("fwd", row["dtype"])], "in_turns": None, "max_abs_err": err, "tol": tol,
            "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_limit": limit, "library_ms": library_ms,
            "library": f"scaled_dot_product_attention ({backend})"}


def bwd_row(label, row, grads, want_grads, times, bnd) -> dict:
    """Check a backward kernel's dq, dk and dv against its plain version's
    (`bwd_tolerance`) and print; -> its kernel row, as `fwd_row`."""
    import torch

    from vit_ae_plus_plus_torch.kernels import bwd_tolerance

    errs, tols = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite {name}")
        errs[name] = (g.float() - w.float()).abs().max().item()
        tols[name] = bwd_tolerance(w)
        check(errs[name] <= tols[name], f"{label}: {name} max abs err {errs[name]:.3g} (tol {tols[name]:.3g})")
    (ms, plain_ms, library_ms, backend), (bound_ms, bound_by, _) = times, bnd
    print(f"kernel {label}: max_abs_err " + ", ".join(f"{k} {errs[k]:.3g} (tol {tols[k]:.3g})" for k in errs)
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({backend}) bwd {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {"launches": None, **row, "route": "cuda", "source": BWD_SOURCE,
            "body": BODIES[("bwd", row["dtype"])], "in_turns": None, "max_abs_err": max(errs.values()),
            "tol": min(tols.values()), "errs": errs, "tols": tols, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library": f"scaled_dot_product_attention ({backend})"}


def kernel_case(label, layout, b, h, n, d, dtype_name, seed):
    """Phase 2 for one shape: error against the plain version, and times."""
    import torch

    from vit_ae_plus_plus_torch.kernels import (
        attention_plain, flash_attention, packed_attention_plain, packed_flash_attention,
    )

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = d**-0.5
    if layout == "packed":
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        kernel = lambda: packed_flash_attention(qkv, d, scale)  # noqa: E731
        plain = lambda: packed_attention_plain(qkv, d, scale)  # noqa: E731
        got = packed_flash_attention(qkv, d, scale, return_lse=True)
        synced(label)
        want = packed_attention_plain(qkv, d, scale, return_lse=True)
    else:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
        kernel = lambda: flash_attention(q, k, v, scale)  # noqa: E731
        plain = lambda: attention_plain(q, k, v, scale)  # noqa: E731
        got = flash_attention(q, k, v, scale, return_lse=True)
        synced(label)
        want = attention_plain(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    times = (graph_ms(kernel), graph_ms(plain, calls=3, reps=2), *sdpa_fwd_ms(sdpa_calls(lambda: (q, k, v), scale)))
    torch.cuda.empty_cache()
    row = {"name": "packed_flash_fwd" if layout == "packed" else "flash_fwd", "replaces": REPLACES[layout],
           "shape": f"B={b} H={h} N={n} d={d}", "dtype": dtype_name, "key": (b, h, n, d, dtype_name)}
    elt = torch.empty((), dtype=dtype).element_size()
    return fwd_row(label, row, got, want, times, bound(b, h, n, d, dtype_name, elt))


def encoder_breakdown(b: int, h: int, n: int, d: int) -> None:
    """Where the bf16 forward's time goes at the step's encoder shape: the
    per-head kernel over the same n query rows against 64, 192 and n keys
    (1, 3 and ceil(n / 64) key tiles a block). The slope is one key tile's
    time over the whole grid; what is left at one tile is the blocks' fixed
    cost (launch, barrier set-up, the Q tile and the first K/V stage in
    flight, the epilogue)."""
    import torch

    from vit_ae_plus_plus_torch.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(90)
    rand = lambda rows: torch.randn((b, h, rows, d), generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q, tiles, times = rand(n), {}, {}
    for nk in (64, 192, n):
        k, v = rand(nk), rand(nk)
        tiles[nk], times[nk] = -(-nk // 64), graph_ms(lambda: flash_attention_fwd(q, k, v, d**-0.5))
    per_tile = (times[n] - times[64]) / (tiles[n] - 1)
    fixed = times[64] - per_tile
    print(f"encoder forward B{b} H{h} N{n} d{d}: "
          + ", ".join(f"{tiles[k]} key tiles {times[k]:.4f} ms" for k in times)
          + f"; {per_tile:.4f} ms a key tile over the grid, fixed {fixed:.4f} ms ({fixed / times[n]:.0%} of "
          f"{times[n]:.4f})", flush=True)


def bwd_case(label, layout, b, h, n, d, dtype_name, seed):
    """Phase 2 for one backward shape: dq, dk and dv of the kernel against
    the plain backward from the same forward (o, lse) and output gradient,
    and times. `library_ms` is SDPA forward+backward minus SDPA forward."""
    import torch

    from vit_ae_plus_plus_torch.kernels import (
        attention_bwd_plain, flash_attention, flash_attention_bwd, packed_attention_bwd_plain,
        packed_flash_attention, packed_flash_attention_bwd,
    )

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = d**-0.5
    if layout == "packed":
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, n, h * d), generator=gen, device="cuda").to(dtype)
        o, lse = packed_flash_attention(qkv, d, scale, return_lse=True)
        kernel = lambda: packed_flash_attention_bwd(qkv, o, lse, do, d, scale)  # noqa: E731
        plain = lambda: packed_attention_bwd_plain(qkv, o, lse, do, d, scale)  # noqa: E731
        got = kernel().chunk(3, dim=-1)
        synced(label)
        want = plain().chunk(3, dim=-1)
        leaves = (qkv.detach().requires_grad_(),)
        heads = lambda: leaves[0].view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)  # noqa: E731
        do_heads = do.view(b, n, h, d).transpose(1, 2)
    else:
        q, k, v, do = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype) for _ in range(4))
        o, lse = flash_attention(q, k, v, scale, return_lse=True)
        kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, scale)  # noqa: E731
        plain = lambda: attention_bwd_plain(q, k, v, o, lse, do, scale)  # noqa: E731
        got = kernel()
        synced(label)
        want = plain()
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        heads = lambda: leaves  # noqa: E731
        do_heads = do
    # one launch's peak allocation: its dq, dk, dv, the delta pre-pass's f32
    # rows and, in f32, the split scratch (the rest)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernel()
    torch.cuda.synchronize()
    launch_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
    elt = torch.empty((), dtype=dtype).element_size()
    outputs_mb = (3 * b * h * n * d * elt + 4 * b * h * n) / 1e6
    print(f"{label}: one launch allocates {launch_mb:.1f} MB at its peak (measured), {outputs_mb:.1f} MB of it "
          f"dq, dk, dv and delta, the split scratch the rest, {launch_mb - outputs_mb:.1f} MB", flush=True)
    library = sdpa_calls(heads, scale)
    times = (graph_ms(kernel), graph_ms(plain, calls=3, reps=2), *sdpa_bwd_ms(library, leaves, do_heads))
    torch.cuda.empty_cache()
    row = {"name": "packed_flash_bwd" if layout == "packed" else "flash_bwd", "replaces": BWD_REPLACES[layout],
           "shape": f"B={b} H={h} N={n} d={d}", "dtype": dtype_name, "key": (b, h, n, d, dtype_name),
           "launch_peak_mb": launch_mb}
    return bwd_row(label, row, got, want, times, bound(b, h, n, d, dtype_name, elt, bwd=True))


def ln_operands(r: int, c: int, dtype, seed: int, f=None):
    """Seeded operands on the card: x (R, C) with mean 1 and spread 2, f32
    gamma near 1 and beta; with `f`, w (F, C) of spread C^-1/2 and b (F,)
    of spread 0.1 in x's dtype (the bias and the product of comparable size
    make a wrong rounding order show) and dy (R, F); else dy (R, C)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = (2 * rand(r, c) + 1).to(dtype)
    gamma, beta = 1 + 0.1 * rand(c), 0.1 * rand(c)
    if f is None:
        return x, gamma, beta, rand(r, c).to(dtype)
    return x, gamma, beta, (c**-0.5 * rand(f, c)).to(dtype), (0.1 * rand(f)).to(dtype), rand(r, f).to(dtype)


def ln_row(name, shape, key, dtype_name, errs, times, nbytes, flops, peak):
    """A kernel row of #6 or #7: the bound is the larger of `nbytes` over the
    memory rate and `flops` at `peak`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    source, replaces = LN_SOURCES[name]
    ms, plain_ms, library_ms = times
    return {
        "name": name, "route": "cuda", "source": source, "body": BODIES[(name, dtype_name)], "in_turns": None,
        "replaces": replaces, "shape": shape, "dtype": dtype_name, "key": key, "launches": None,
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "errs": errs,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes > t_ops else "operations", "library_ms": library_ms,
    }


def report(label: str, row: dict) -> None:
    print(f"kernel {label}: " + ", ".join(
        f"{k} {e['max_abs_err']:.3g} (tol {e['tol']:.3g}, differing {e['mismatch']:.2%} of "
        f"{e['mismatch_tol']:.0%})" for k, e in row["errs"].items())
        + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    for k, e in row["errs"].items():
        check(e["ok"], f"{label}: {k} {e}")


def ln_dense_cases(label, r, c, f, dtype_name, seed):
    """Phase 2 for kernel #7 at one shape, forward (7a) and backward (7b):
    y, mu, rstd, dx and dln against the plain versions on the same inputs,
    and times. Library: F.layer_norm + F.linear forward; dY @ W (cuBLAS) +
    aten.native_layer_norm_backward for dx backward."""
    import torch
    import torch.nn.functional as F

    from vit_ae_plus_plus_torch.kernels import ln_dense_bwd_plain, ln_dense_plain
    from vit_ae_plus_plus_torch.kernels.fused_ln import compare
    from vit_ae_plus_plus_torch.kernels.fused_ln_dense import dln_tolerance, ln_dense_bwd, ln_dense_fwd

    dtype = getattr(torch, dtype_name)
    elt = torch.empty((), dtype=dtype).element_size()
    x, gamma, beta, w, b, dy = ln_operands(r, c, dtype, seed, f)
    y, mu, rstd = ln_dense_fwd(x, gamma, beta, w, b, 1e-6)
    dx, dln = ln_dense_bwd(x, gamma, w, dy, mu, rstd)
    synced(label)
    want_y, want_mu, want_rstd = ln_dense_plain(x, gamma, beta, w, b, 1e-6)
    want_dx, want_dln = ln_dense_bwd_plain(x, gamma, w, dy, want_mu, want_rstd)
    torch.cuda.synchronize()
    fwd_errs = {"y": compare(y, want_y), "mu": compare(mu, want_mu), "rstd": compare(rstd, want_rstd)}
    dln_err = (dln - want_dln).abs().max().item()
    dln_tol = dln_tolerance(want_dln, dtype)
    bwd_errs = {"dx": compare(dx, want_dx),
                "dln": {"max_abs_err": dln_err, "tol": dln_tol, "mismatch": 0.0, "mismatch_tol": 1.0,
                        "ok": bool(torch.isfinite(dln).all()) and dln_err <= dln_tol}}
    del y, want_y, dx, want_dx, dln, want_dln
    torch.cuda.empty_cache()

    gc, bc = gamma.to(dtype), beta.to(dtype)
    fwd_times = (
        graph_ms(lambda: ln_dense_fwd(x, gamma, beta, w, b, 1e-6)),
        graph_ms(lambda: ln_dense_plain(x, gamma, beta, w, b, 1e-6)),
        graph_ms(lambda: F.linear(F.layer_norm(x, (c,), gc, bc, 1e-6), w, b)),
    )
    _, lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(x, [c], gc, bc, 1e-6)
    bwd_times = (
        graph_ms(lambda: ln_dense_bwd(x, gamma, w, dy, mu, rstd)),
        graph_ms(lambda: ln_dense_bwd_plain(x, gamma, w, dy, mu, rstd)),
        graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy @ w, x, [c], lib_mean, lib_rstd, gc, bc, [True, False, False])),
    )
    torch.cuda.empty_cache()
    peak = PEAK_FLOPS[dtype_name]
    shape, key = f"R={r} C={c} F={f}", (r, c, f, dtype_name)
    # bytes: x, W, b, gamma, beta read; y, mu, rstd written / dY, W, x,
    # gamma, mu, rstd read; dx and the f32 dln written
    fwd = ln_row("ln_dense_fwd", shape, key, dtype_name, fwd_errs, fwd_times,
                 (r * c + f * c + f + r * f) * elt + (2 * c + 2 * r) * 4, 2 * r * c * f, peak)
    bwd = ln_row("ln_dense_bwd", shape, key, dtype_name, bwd_errs, bwd_times,
                 (r * f + f * c + 2 * r * c) * elt + (c + 2 * r + r * c) * 4, 2 * r * c * f, peak)
    report(f"{label} fwd", fwd)
    report(f"{label} bwd", bwd)
    return [fwd, bwd]


def layernorm_cases(label, r, c, dtype_name, seed):
    """Phase 2 for kernel #6 at one shape, forward (6a) and backward (6b),
    and times, with the operands cold in L2 (they fit in it). Library:
    F.layer_norm, and aten.native_layer_norm_backward for dx. Bound: bytes
    (a few f32 operations per element, far under the card's f32 rate)."""
    import torch
    import torch.nn.functional as F

    from vit_ae_plus_plus_torch.kernels import layernorm_bwd_plain, layernorm_plain
    from vit_ae_plus_plus_torch.kernels.fused_ln import compare, layernorm_bwd, layernorm_fwd

    dtype = getattr(torch, dtype_name)
    elt = torch.empty((), dtype=dtype).element_size()
    x, gamma, beta, dy = ln_operands(r, c, dtype, seed)
    y, mu, rstd = layernorm_fwd(x, gamma, beta, 1e-6)
    dx = layernorm_bwd(x, gamma, mu, rstd, dy)
    synced(label)
    want_y, want_mu, want_rstd = layernorm_plain(x, gamma, beta, 1e-6)
    want_dx = layernorm_bwd_plain(x, gamma, want_mu, want_rstd, dy)
    torch.cuda.synchronize()
    fwd_errs = {"y": compare(y, want_y), "mu": compare(mu, want_mu), "rstd": compare(rstd, want_rstd)}
    bwd_errs = {"dx": compare(dx, want_dx)}
    gc, bc = gamma.to(dtype), beta.to(dtype)
    _, lib_mean, lib_rstd = torch.ops.aten.native_layer_norm(x, [c], gc, bc, 1e-6)
    fwd_times = (
        graph_ms(lambda: layernorm_fwd(x, gamma, beta, 1e-6), cold=True),
        graph_ms(lambda: layernorm_plain(x, gamma, beta, 1e-6), cold=True),
        graph_ms(lambda: F.layer_norm(x, (c,), gc, bc, 1e-6), cold=True),
    )
    bwd_times = (
        graph_ms(lambda: layernorm_bwd(x, gamma, mu, rstd, dy), cold=True),
        graph_ms(lambda: layernorm_bwd_plain(x, gamma, mu, rstd, dy), cold=True),
        graph_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [c], lib_mean, lib_rstd, gc, bc, [True, False, False]), cold=True),
    )
    torch.cuda.empty_cache()
    shape, key = f"R={r} C={c}", (r, c, dtype_name)
    f32 = F32_SIMT_FLOPS
    fwd = ln_row("layernorm_fwd", shape, key, dtype_name, fwd_errs, fwd_times,
                 2 * r * c * elt + (2 * c + 2 * r) * 4, 8 * r * c, f32)
    bwd = ln_row("layernorm_bwd", shape, key, dtype_name, bwd_errs, bwd_times,
                 3 * r * c * elt + (c + 2 * r) * 4, 10 * r * c, f32)
    report(f"{label} fwd", fwd)
    report(f"{label} bwd", bwd)
    return [fwd, bwd]


def ring_case(label, b, h, n, d, shards, seed, full_pad=False, dtype_name="bfloat16"):
    """Phase 6 for one ring block, forward and backward: rank 0's query rows
    against the last rank's block (where the padded tail lies; K and V pad
    rows are zeros, as the ring pads them) with its key bias, or with every
    key padded (`full_pad`). The backward takes the o and lse of each row
    over the whole sequence, as the merge hands them over. SDPA takes the
    bias as a float mask of the operands' dtype."""
    import torch

    from vit_ae_plus_plus_torch.kernels import (
        attention_bwd_plain, attention_plain, ring_partial_bwd, ring_partial_fwd,
    )
    from vit_ae_plus_plus_torch.kernels.ring_flash import NEG_INF
    from vit_ae_plus_plus_torch.parallel import padded_len

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale, pn = d**-0.5, padded_len(n, shards)
    nb = pn // shards
    dtype = getattr(torch, dtype_name)
    rand = lambda rows: torch.randn((b, h, rows, d), generator=gen, device="cuda").to(dtype)  # noqa: E731
    q, k, v = (torch.nn.functional.pad(rand(n), (0, 0, 0, pn - n)) for _ in range(3))
    bias = torch.where(torch.arange(pn, device="cuda") < n, 0.0, NEG_INF).float()
    q_l, do = q[:, :, :nb].contiguous(), rand(nb)
    kb, vb = (t[:, :, pn - nb:].contiguous() for t in (k, v))
    bb = torch.full((nb,), NEG_INF, device="cuda") if full_pad else bias[pn - nb:].contiguous()
    o_row, lse_row = attention_plain(q_l, k, v, scale, return_lse=True, bias=bias)

    fwd = lambda: ring_partial_fwd(q_l, kb, vb, bb, scale)  # noqa: E731
    bwd = lambda: ring_partial_bwd(q_l, do, o_row, lse_row, kb, vb, bb, scale)  # noqa: E731
    plain_fwd = lambda: attention_plain(q_l, kb, vb, scale, return_lse=True, bias=bb)  # noqa: E731
    plain_bwd = lambda: attention_bwd_plain(q_l, kb, vb, o_row, lse_row, do, scale, bb)  # noqa: E731
    got, grads = fwd(), bwd()
    synced(label)
    if full_pad:  # lse about -1e30, so the merge weights it 0; no gradient reaches its keys
        check(float(got[1].max()) < -1e29 and float(grads[1].abs().max()) == 0.0
              and float(grads[2].abs().max()) == 0.0, f"{label}: a fully padded block is not inert")
    leaves = tuple(t.detach().requires_grad_() for t in (q_l, kb, vb))
    library = sdpa_calls(lambda: leaves, scale, mask=bb.to(dtype).view(1, 1, 1, nb))
    times = ((graph_ms(fwd), graph_ms(plain_fwd, calls=3, reps=2), *sdpa_fwd_ms(library)),
             (graph_ms(bwd), graph_ms(plain_bwd, calls=3, reps=2), *sdpa_bwd_ms(library, leaves, do)))
    torch.cuda.empty_cache()
    row = {"shape": f"B={b} H={h} NB={nb} d={d} (of N={n} over {shards})", "dtype": dtype_name,
           "key": (b, h, nb, d, dtype_name)}
    if full_pad:
        row.update(launches=0, path="none: a fully padded block, correctness only")
    lse_bias = b * h * nb * 4 + nb * 4  # the f32 lse and the f32 key bias
    elt = torch.empty((), dtype=dtype).element_size()
    return [
        fwd_row(label, {**row, "name": "ring_flash_fwd", "replaces": RING_REPLACES["fwd"]}, got, plain_fwd(),
                times[0], bound(b, h, nb, d, dtype_name, elt, extra_bytes=lse_bias), lse_relative=full_pad),
        bwd_row(f"{label} bwd", {**row, "name": "ring_flash_bwd", "replaces": RING_REPLACES["bwd"]}, grads,
                plain_bwd(), times[1], bound(b, h, nb, d, dtype_name, elt, bwd=True, extra_bytes=lse_bias)),
    ]


def seq_case(label, b, h, n, d, shards, seed):
    """Phase 6 for the sequence-sharded shard: the per-head kernels with
    rank 0's pn / shards query rows against all n keys, forward and
    backward, against their plain versions."""
    import torch

    from vit_ae_plus_plus_torch.kernels import attention_bwd_plain, attention_plain
    from vit_ae_plus_plus_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from vit_ae_plus_plus_torch.parallel import padded_len

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale, nq = d**-0.5, padded_len(n, shards) // shards
    rand = lambda rows: torch.randn((b, h, rows, d), generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    q_l, k, v, do = rand(nq), rand(n), rand(n), rand(nq)
    fwd = lambda: flash_attention_fwd(q_l, k, v, scale)  # noqa: E731
    o, lse = got = fwd()
    bwd = lambda: flash_attention_bwd(q_l, k, v, o, lse, do, scale)  # noqa: E731
    grads = bwd()
    synced(label)
    plain_fwd = lambda: attention_plain(q_l, k, v, scale, return_lse=True)  # noqa: E731
    plain_bwd = lambda: attention_bwd_plain(q_l, k, v, o, lse, do, scale)  # noqa: E731
    leaves = tuple(t.detach().requires_grad_() for t in (q_l, k, v))
    library = sdpa_calls(lambda: leaves, scale)
    times = ((graph_ms(fwd), graph_ms(plain_fwd, calls=3, reps=2), *sdpa_fwd_ms(library)),
             (graph_ms(bwd), graph_ms(plain_bwd, calls=3, reps=2), *sdpa_bwd_ms(library, leaves, do)))
    torch.cuda.empty_cache()
    row = {"shape": f"B={b} H={h} N={nq} Nk={n} d={d} (a shard of {shards})", "dtype": "bfloat16",
           "key": (b, h, nq, d, "bfloat16")}
    lse_bytes = b * h * nq * 4
    return [
        fwd_row(label, {**row, "name": "flash_fwd", "replaces": REPLACES["per_head"]}, got, plain_fwd(),
                times[0], bound(b, h, nq, d, "bfloat16", 2, nk=n, extra_bytes=lse_bytes)),
        bwd_row(f"{label} bwd", {**row, "name": "flash_bwd", "replaces": BWD_REPLACES["per_head"]}, grads,
                plain_bwd(), times[1], bound(b, h, nq, d, "bfloat16", 2, nk=n, bwd=True, extra_bytes=lse_bytes)),
    ]


def ring_shapes(cfg) -> list:
    """(label, B, H, N, d) of the ring blocks of phase 7's paths: ViT-B at
    128^3, the step's decoder and its encoder, each over GROUP_RANKS."""
    return [("ring bf16 NB1032 d64 (ViT-B 128^3)", 2, 12, 4097, 64),
            ("ring bf16 NB440 d32 (decoder)", BATCH, 16, cfg.num_patches + 1, 32),
            ("ring bf16 NB112 d64 (encoder)", *train_shapes(cfg)[0][:3], 64)]


def f32_lnd_cases(cfg) -> list:
    """(label, R, C, F, seed) of the f32 LayerNorm+Dense cases: qkv (F = 3C)
    and fc1 (F = 4C) at the training encoder's and decoder's (R, C), the
    shapes of the f32 ln_fusion="on" step."""
    shapes = ln_shapes(cfg)
    return [(f"ln_dense f32 {where} {layer} R{r} C{c} F{f}", r, c, f, 50 + 2 * i + j)
            for i, where in enumerate(("encoder", "decoder")) for r, c in [shapes[where]]
            for j, (layer, f) in enumerate((("qkv", 3 * c), ("fc1", 4 * c)))]


def turn_cases(cfg) -> list:
    """(row name, row key, case call) for every f32 attention forward and
    backward row of the training step: its encoder and decoder shapes and
    the fast preset's two, packed and per-head, and the forward at the f32
    slab's B8 H12 N1729 d64 (the seeds of `main`'s rows; the per-head
    forward rows, which `main` has not, seeds of their own); the rows that
    `--parent` times in turns against another checkout's bodies. The calls
    are this script's case functions, which that checkout's copy has too."""
    enc, dec = train_shapes(cfg)
    slab = (BATCH, 12, cfg.num_patches + 1, 64)
    fwd = [("packed f32 N1729 d64", "packed", slab, 4),
           ("per-head f32 N1729 d64", "per_head", slab, 200),
           ("packed f32 N433 d64 (encoder)", "packed", enc, 19),
           ("per-head f32 N433 d64 (encoder)", "per_head", enc, 201),
           ("packed f32 N1729 d32 (decoder)", "packed", dec, 20),
           ("per-head f32 N1729 d32 (decoder)", "per_head", dec, 202),
           ("packed f32 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, 94),
           ("packed f32 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, 95),
           ("per-head f32 N433 d128 (encoder, fast preset)", "per_head", FAST_ENC, 203),
           ("per-head f32 N1729 d128 (decoder, fast preset)", "per_head", FAST_DEC, 204)]
    heads = [("packed bwd f32 N433 d64 (encoder)", "packed", enc, 21),
             ("per-head bwd f32 N433 d64 (encoder)", "per_head", enc, 22),
             ("packed bwd f32 N1729 d32 (decoder)", "packed", dec, 18),
             ("per-head bwd f32 N1729 d32 (decoder)", "per_head", dec, 23),
             ("packed bwd f32 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, 26),
             ("packed bwd f32 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, 27),
             ("per-head bwd f32 N433 d128 (encoder, fast preset)", "per_head", FAST_ENC, 90),
             ("per-head bwd f32 N1729 d128 (decoder, fast preset)", "per_head", FAST_DEC, 91)]
    return [(f"{'packed_' if layout == 'packed' else ''}flash_{way}", (*shape, "float32"),
             f"{case}('{label}', '{layout}', {', '.join(map(str, shape))}, 'float32', seed={seed})")
            for way, case, rows in (("fwd", "kernel_case", fwd), ("bwd", "bwd_case", heads))
            for label, layout, shape, seed in rows]


# One turn in another checkout: its own chip_smoke's case functions (each
# call once), each call's row of the given name -> its kernel, SDPA and
# bound ms; the f32 serving slab's device time (CUDA events over 3 slabs)
# and its peak allocation above the engine's resident bytes; and the f32
# training step's time (CUDA events over 3 steps after one warm-up) and
# peak allocation, unfused and with ln_fusion="on", and the fast preset's
# (its Trainer built with that checkout's MODEL set to the preset), from
# that checkout's FeatureEngine and Trainer, as one JSON line
TURN_CHILD = """
import json, sys
import numpy as np
import torch
import chip_smoke as cs
from vit_ae_plus_plus_torch.models import MODEL_ZOO
from vit_ae_plus_plus_torch.serving import FeatureEngine
from vit_ae_plus_plus_torch.train.step import feature_step
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out, done = [], {}
for name, call in json.loads(sys.argv[1]):
    if call not in done:
        got = eval("cs." + call)
        done[call] = got if isinstance(got, list) else [got]
    row = next(r for r in done[call] if r["name"] == name)
    out.append({k: row[k] for k in ("ms", "library_ms", "bound_ms")})
cfg = MODEL_ZOO[cs.MODEL](volume_size=cs.VOLUME, patch_size=cs.PATCH)
engine = FeatureEngine(mae_params=cs.mae_encoder_tree(cfg, seed=0), model_name=cs.MODEL, volume_size=cs.VOLUME,
                       patch_size=cs.PATCH, batch_size=cs.BATCH, compute_dtype="float32")
vols = np.random.default_rng(5).standard_normal((cs.BATCH, 1, cs.VOLUME, cs.VOLUME, cs.VOLUME)).astype(np.float32)
slab = torch.from_numpy(vols).cuda()
slab_ms = cs.cuda_ms(lambda: feature_step(engine.model, slab), reps=3)
base = cs.reset_peak()
feature_step(engine.model, slab)
torch.cuda.synchronize()
slab_mb = (torch.cuda.max_memory_allocated() - base) / 1e6
del engine, slab
tree, stats = cs.mae_tree(cfg, seed=0)
views, _ = cs.train_inputs(cfg)
steps, peaks = {}, {}
for which, model, fusion in (("auto", cs.MODEL, "auto"), ("on", cs.MODEL, "on"),
                             ("fast", "contr_mae_vit_base_patch16_fast", "auto")):
    cs.MODEL, main_model = model, cs.MODEL
    trainer = cs.Trainer(tree, stats, "float32", "auto", ln_fusion=fusion)
    cs.MODEL = main_model
    cs.reset_peak()
    steps[which] = cs.step_ms(trainer, views, reps=3)[0]
    peaks[which] = torch.cuda.max_memory_allocated() / 2**30
    del trainer
    torch.cuda.empty_cache()
print("TURN " + json.dumps({"rows": out, "slab_ms": slab_ms, "slab_mb": slab_mb, "step_ms": steps,
                            "step_gib": peaks}))
"""


def turn_ms(checkout: Path, cases: list) -> dict:
    """Kernel ms of each case's row and the f32 step's ms, timed by
    `checkout`'s own copy of this script in a process of its own, on the
    card this process leaves idle."""
    import torch

    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, "-c", TURN_CHILD, json.dumps([[n, c] for n, _, c in cases])],
                          cwd=checkout, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    check(proc.returncode == 0 and last.startswith("TURN "),
          f"turn in {checkout} failed: {(proc.stderr.strip().splitlines() or ['(no message)'])[-1]}")
    return json.loads(last[5:])


def in_turns_phase(rows: list, cfg, parent: Path, parent_build) -> None:
    """The redesigned rows timed in turns against `parent`'s bodies, on this
    card in this run: parent, this checkout, this checkout, parent. Each
    row gets `in_turns` {"parent_ms": [..], "ms": [..]}; a case without a
    row here (the per-head f32 forward rows) is printed with its SDPA and
    bound ms from this checkout's turns. Then the f32 slab's and steps'
    times and peak allocations of each turn."""
    log, _ = parent_build.communicate(timeout=600)
    check(parent_build.returncode == 0, f"the parent checkout's kernels did not build:\n{log[-2000:]}")
    cases = turn_cases(cfg)
    t0 = time.perf_counter()
    first = turn_ms(parent, cases)
    mine = [turn_ms(REPO, cases) for _ in range(2)]
    last = turn_ms(parent, cases)
    for i, (name, key, _) in enumerate(cases):
        parent_ms = [first["rows"][i]["ms"], last["rows"][i]["ms"]]
        ms = [mine[0]["rows"][i]["ms"], mine[1]["rows"][i]["ms"]]
        row = next((r for r in rows if r["name"] == name and r["key"] == key), None)
        if row is not None:
            row["in_turns"] = {"parent_ms": parent_ms, "ms": ms}
        ours = [turn["rows"][i] for turn in mine]
        extra = "" if row is not None else (
            f" (no phase 2 row: sdpa {ours[0]['library_ms']:.4f}, {ours[1]['library_ms']:.4f} ms, "
            f"bound {ours[0]['bound_ms']:.4f} ms)")
        print(f"in turns {name} {key[:-1]}: parent {parent_ms[0]:.4f}, {parent_ms[1]:.4f} ms -> "
              f"{ms[0]:.4f}, {ms[1]:.4f} ms{extra}", flush=True)
    turns = (first, mine[0], mine[1], last)
    print(f"in turns, f32 slab of {BATCH} (feature_step, CUDA events over 3 slabs): parent "
          f"{first['slab_ms']:.2f}, {last['slab_ms']:.2f} -> {mine[0]['slab_ms']:.2f}, {mine[1]['slab_ms']:.2f} ms; "
          "peak allocation above the engine's resident bytes "
          + ", ".join(f"{t['slab_mb']:.1f}" for t in turns) + " MB (parent, this, this, parent)", flush=True)
    for fusion, what in (("auto", "unfused"), ("on", "ln_fusion='on'"), ("fast", FAST_MODEL)):
        print(f"in turns, f32 step {what}, ms per step of {BATCH} (CUDA events over 3 steps): parent "
              f"{first['step_ms'][fusion]:.2f}, {last['step_ms'][fusion]:.2f} -> {mine[0]['step_ms'][fusion]:.2f}, "
              f"{mine[1]['step_ms'][fusion]:.2f}; max_memory_allocated "
              + ", ".join(f"{t['step_gib'][fusion]:.2f}" for t in turns) + " GiB (parent, this, this, parent)",
              flush=True)
    print(f"in-turns phase {time.perf_counter() - t0:.1f}s", flush=True)


def dense(rng, fan_in: int, fan_out: int, bias: bool = True) -> dict:
    """A flax Dense leaf: xavier-uniform kernel, as the JAX init."""
    lim = np.sqrt(6.0 / (fan_in + fan_out))
    leaf = {"kernel": rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)}
    if bias:
        leaf["bias"] = (0.02 * rng.standard_normal(fan_out)).astype(np.float32)
    return leaf


def ln(rng, dim: int) -> dict:
    return {"scale": (1 + 0.1 * rng.standard_normal(dim)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(dim)).astype(np.float32)}


def mae_encoder_tree(cfg, seed: int) -> dict:
    """Seeded numpy weights in the JAX package's MAE param-tree layout (the
    encoder's leaves: the only ones the feature graft reads)."""
    rng = np.random.default_rng(seed)
    d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    tree = {
        "patch_embed": {"proj": dense(rng, cfg.patch_size**3 * cfg.in_chans, d)},
        "cls_token": (0.02 * rng.standard_normal((1, 1, d))).astype(np.float32),
        "norm": ln(rng, d),
    }
    for i in range(cfg.depth):
        tree[f"blocks_{i}"] = {
            "norm1": ln(rng, d), "norm2": ln(rng, d),
            "attn": {"qkv": dense(rng, d, 3 * d), "proj": dense(rng, d, d)},
            "mlp": {"Dense_0": dense(rng, d, hidden), "Dense_1": dense(rng, hidden, d)},
        }
    return tree


def mae_tree(cfg, seed: int):
    """Seeded numpy weights for the whole MAE param tree (encoder, decoder,
    contrastive predictor) and its flax `batch_stats`, in the JAX package's
    layout."""
    rng = np.random.default_rng(seed + 1)
    tree = mae_encoder_tree(cfg, seed)
    d, dd, hidden = cfg.embed_dim, cfg.decoder_embed_dim, int(cfg.decoder_embed_dim * cfg.mlp_ratio)
    tree["decoder_embed"] = dense(rng, d, dd)
    tree["mask_token"] = (0.02 * rng.standard_normal((1, 1, dd))).astype(np.float32)
    for i in range(cfg.decoder_depth):
        tree[f"decoder_blocks_{i}"] = {
            "norm1": ln(rng, dd), "norm2": ln(rng, dd),
            "attn": {"qkv": dense(rng, dd, 3 * dd), "proj": dense(rng, dd, dd)},
            "mlp": {"Dense_0": dense(rng, dd, hidden), "Dense_1": dense(rng, hidden, dd)},
        }
    tree["decoder_norm"] = ln(rng, dd)
    tree["decoder_pred"] = dense(rng, dd, cfg.patch_size**3 * cfg.in_chans)
    tree["heads"] = {"predictor": {"Dense_0": dense(rng, d, d, bias=False), "BatchNorm_0": ln(rng, d),
                                   "Dense_1": dense(rng, d, d)}}
    stats = {"heads": {"predictor": {"BatchNorm_0": {
        "mean": (0.1 * rng.standard_normal(d)).astype(np.float32),
        "var": (1 + 0.1 * rng.random(d)).astype(np.float32)}}}}
    return tree, stats


def rel_err(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def post_features(port: int, vols: np.ndarray):
    buf = io.BytesIO()
    np.save(buf, vols)
    req = urllib.request.Request(f"http://127.0.0.1:{port}/features", data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body = r.status, r.read()
    return status, np.load(io.BytesIO(body)), time.perf_counter() - t0


def serve_phase(engine) -> dict:
    """The main path: HTTP requests through the batching queue to the engine,
    with every launch count set to 0 just before and read just after.

    A correctness check: the traffic (8 closed-loop clients, 1-3 volumes
    per request) follows no workload source and is too short to measure
    served throughput or latency; those are printed as information only."""
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.serving import BatchingQueue, make_http_server

    rng = np.random.default_rng(11)
    sizes = [1, 2, 3] * 8  # 48 volumes in 24 requests from 8 clients
    requests = [rng.standard_normal((s, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32) for s in sizes]
    want = [engine.infer(r) for r in requests]

    queue = BatchingQueue(engine, max_wait_ms=5.0)
    server = make_http_server(queue, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    results = [None] * len(requests)

    def client(idxs):
        for i in idxs:
            results[i] = post_features(port, requests[i])

    clients = [threading.Thread(target=client, args=(list(range(c, len(requests), 8)),)) for c in range(8)]
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = shape_counts()
        stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60).read())
    finally:
        server.shutdown()
        queue.close()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    check(all(r is not None for r in results), "a request got no answer")
    served_err = 0.0
    for i, ((status, feats, _), ref) in enumerate(zip(results, want)):
        check(status == 200, f"request {i}: status {status}")
        check(feats.shape == (sizes[i], engine.feature_dim), f"request {i}: shape {feats.shape}")
        check(bool(np.isfinite(feats).all()), f"request {i}: non-finite features")
        served_err = max(served_err, rel_err(feats, ref))
    check(served_err <= SERVED_TOL, f"served vs engine.infer rel err {served_err:.3g}")
    check(stats["total_requests"] == sum(sizes), f"/stats counted {stats['total_requests']}")
    slabs = stats["total_batches"]
    launches = totals(counts)
    check(launches == {**NO_LAUNCHES, "packed_flash_fwd": 12 * slabs},
          f"{slabs} slabs launched {launches} (want 12 packed forward per slab and nothing else)")
    latencies = sorted(r[2] for r in results)
    summary = {
        "requests": len(sizes), "volumes": sum(sizes), "slabs": slabs,
        "packed_launches": launches["packed_flash_fwd"], "served_vs_infer_rel_err": served_err,
    }
    print(f"serve: {json.dumps(summary)}", flush=True)
    print(f"serve, information only (a {wall:.2f} s burst, not a load test): "
          f"{sum(sizes) / wall:.1f} volumes/s, client p50 {1e3 * latencies[len(latencies) // 2]:.1f} ms, "
          f"server p50 {stats['latency_p50_ms']:.1f} ms, mean batch fill {stats['mean_batch_fill']:.2f}",
          flush=True)
    return summary, counts


def path_launches(engine, vols):
    """Run one slab through `engine` with the counts reset just before:
    -> features, launches by (wrapper, shape)."""
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts

    reset_launch_counts()
    feats = engine.infer(vols)
    return feats, shape_counts()


def slab_ms(engine, vols, reps: int = 5) -> float:
    import torch

    engine.infer(vols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.infer(vols)
    return (time.perf_counter() - t0) / reps * 1e3


WRAPPERS = ("packed_flash_fwd", "packed_flash_bwd", "flash_fwd", "flash_bwd", "layernorm_fwd",
            "layernorm_bwd", "ln_dense_fwd", "ln_dense_bwd", "ring_flash_fwd", "ring_flash_bwd")  # kernel rows' names
NO_LAUNCHES = dict.fromkeys(WRAPPERS, 0)


def shape_counts() -> dict:
    """Launches since the last reset, by (row name, shape key): (B, H, N, d,
    dtype) for attention (N: q's rows), (R, C, dtype) for LayerNorm,
    (R, C, F, dtype) for LayerNorm+Dense."""
    from vit_ae_plus_plus_torch.kernels import (
        flash_attention, flash_attention_bwd, fused_layernorm, fused_ln_dense, layernorm_bwd, ln_dense_bwd,
        packed_flash_attention, packed_flash_attention_bwd, ring_partial_bwd, ring_partial_fwd,
    )

    wrappers = (packed_flash_attention, packed_flash_attention_bwd, flash_attention, flash_attention_bwd,
                fused_layernorm, layernorm_bwd, fused_ln_dense, ln_dense_bwd, ring_partial_fwd, ring_partial_bwd)
    return {(name, key): n for name, fn in zip(WRAPPERS, wrappers) for key, n in fn.launches_by_shape.items()}


def ln_shapes(cfg) -> dict:
    """(R, C) of the blocks' LayerNorms: the training encoder over both
    masked views, the training decoder, and one serving slab."""
    from vit_ae_plus_plus_torch.configs import TrainConfig

    kept = int(cfg.num_patches * (1 - TrainConfig().mask_ratio)) + 1
    return {"encoder": (2 * BATCH * kept, cfg.embed_dim),
            "decoder": (BATCH * (cfg.num_patches + 1), cfg.decoder_embed_dim),
            "serving": (BATCH * (cfg.num_patches + 1), cfg.embed_dim)}


def ln_dense_launches(shapes, dtype: str, ways=("fwd", "bwd"), depths=None) -> dict:
    """LayerNorm+Dense launches of one pass: per block one at qkv (F = 3C)
    and one at fc1 (F = 4C), at each (R, C) of `shapes` with its depth."""
    out = {}
    for (r, c), depth in zip(shapes, depths):
        for f in (3 * c, 4 * c):
            for way in ways:
                out[(f"ln_dense_{way}", (r, c, f, dtype))] = depth
    return out


def totals(counts: dict) -> dict:
    """Launches by row name, over all shapes."""
    out = dict(NO_LAUNCHES)
    for (name, _), n in counts.items():
        out[name] += n
    return out


def fill_launches(rows: list, counts: dict, path: str) -> None:
    """A row not yet filled takes the launches that its wrapper made at its
    shape and dtype in `counts` (one path's run), if that run made any."""
    for row in rows:
        n = counts.get((row["name"], row["key"]), 0)
        if row["launches"] is None and n:
            row["launches"], row["path"] = n, path


class Trainer:
    """One training run of the port's public API: `build_model`, the weight
    bridge, `make_adamw`, `create_train_state`, `make_train_step`; with
    `accum_iter` > 1 the accumulating AdamW, with `perceptual_fn` the VGG
    term at `perceptual_weight` (phase 5i)."""

    def __init__(self, tree, stats, dtype: str, attn_impl: str, ln_fusion: str = "auto", accum_iter: int = 1,
                 perceptual_fn=None, perceptual_weight: float = 0.0):
        import torch

        from vit_ae_plus_plus_torch.configs import TrainConfig
        from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
        from vit_ae_plus_plus_torch.train import (
            create_train_state, make_adamw, make_train_step, warmup_cosine_schedule,
        )
        from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

        tc = TrainConfig()
        self.cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH, dtype=dtype, attn_impl=attn_impl,
                                    ln_fusion=ln_fusion)
        self.label = f"{attn_impl} ln_fusion={ln_fusion}"
        self.grad_names = FUSED_GRAD_NAMES if ln_fusion != "auto" else GRAD_NAMES
        model = build_model(self.cfg)
        model.load_state_dict(params_from_jax(tree, PATCH, 1, stats), strict=True)
        self.model = model.cuda()
        lr = tc.blr * BATCH / 256
        # no warmup here: the warmup's first learning rate is 0, and the smoke
        # run checks that the first update moves the parameters
        schedule = warmup_cosine_schedule(lr, tc.min_lr, 0, tc.epochs, steps_per_epoch=4)
        self.state = create_train_state(
            self.model, make_adamw(schedule, weight_decay=tc.weight_decay, accum_iter=accum_iter), seed=0)
        self.kw = dict(mask_ratio=tc.mask_ratio, contr_weight=tc.contr_weight, perceptual_fn=perceptual_fn,
                       perceptual_weight=perceptual_weight)
        self.step = make_train_step(self.model, PATCH, **self.kw)
        self.emw = 0.01  # the edge-loss weight of epoch 0

    def run(self, views, noise=None):
        """One step; masking noise injected when given, else drawn from the
        state's generator (the default path). -> metrics as floats, launch
        counts by (wrapper, shape) read around the step."""
        from vit_ae_plus_plus_torch.kernels import reset_launch_counts
        from vit_ae_plus_plus_torch.train import make_train_step

        step = self.step if noise is None else make_train_step(
            self.model, PATCH, forward_fn=lambda m, a, b, _g: m(a, b, noise=noise), **self.kw)
        reset_launch_counts()
        self.state, metrics = step(self.state, *views, self.emw)
        metrics = {k: float(v) for k, v in metrics.items()}
        counts = shape_counts()
        check(all(np.isfinite(v) for v in metrics.values()), f"non-finite metrics {metrics}")
        return metrics, counts

    def grads(self) -> dict:
        named = dict(self.model.named_parameters())
        return {n: named[n].grad.float().clone() for n in self.grad_names}

    def stats(self) -> dict:
        """The BatchNorm running statistics, on the host."""
        return {n: b.float().cpu().clone() for n, b in self.state.batch_stats.items()}

    def all_grads_finite(self) -> bool:
        import torch

        return all(bool(torch.isfinite(p.grad).all()) for p in self.model.parameters())


def preset_trainer(model: str, *args, **kw) -> Trainer:
    """A `Trainer` of the preset `model` in place of MODEL (TURN_CHILD does
    the same swap inline, since it runs other checkouts' copies too)."""
    global MODEL
    main_model, MODEL = MODEL, model
    try:
        trainer = Trainer(*args, **kw)
    finally:
        MODEL = main_model
    trainer.label += f" {model}"
    return trainer


def step_rel_errs(got: dict, want: dict, got_grads: dict, want_grads: dict) -> dict:
    """Step-1 errors: each loss term over its own magnitude, each gradient
    over its largest magnitude."""
    errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want if want[k] != 0.0}
    for n in want_grads:
        errs[n] = float((got_grads[n] - want_grads[n]).abs().max() / want_grads[n].abs().max())
    return errs


# device kernels of one step, by family of kernel name
KERNEL_FAMILIES = (
    ("attention (flash_fwd.cu, flash_bwd.cu)", ("flash_",)),
    ("LayerNorm+Dense, LayerNorm (ln_dense.cu, layernorm.cu)", ("vitae_ln",)),
    ("GEMM (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")),
    ("optimizer, EMA (foreach: AdamW, LARS)", ("multi_tensor_apply",)),
    ("LayerNorm fwd/bwd", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def profile_step(trainer, views, step_ms_events: float) -> None:
    """One step of the trainer's path under torch.profiler (see
    `profile_run`)."""
    trainer.run(views)

    def step():
        trainer.state, _ = trainer.step(trainer.state, *views, trainer.emw)

    profile_run(step, f"{trainer.cfg.dtype} {trainer.label} step", step_ms_events)


def profile_run(fn, what: str, ms_events: float) -> float:
    """`fn` once under torch.profiler: the device kernels' time by family and
    by name (top 15), their count, and the device's busy share of `what`'s
    time measured without the profiler. -> the device's busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    by_name, by_family = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        family = next((f for f, keys in KERNEL_FAMILIES if any(k in e.name for k in keys)),
                      "elementwise, reductions, gathers, filters (rest)")
        by_family[family] = by_family.get(family, 0.0) + us
    busy_ms = sum(by_name.values()) / 1e3
    check(busy_ms > 0, "the profiler saw no device kernel")
    print(f"profile, information only: {len(kernels)} device kernels, busy {busy_ms:.2f} ms = "
          f"{busy_ms / ms_events:.1%} of the {ms_events:.2f} ms {what} (idle "
          f"{1 - busy_ms / ms_events:.1%})", flush=True)
    for family, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:8.2f} ms  {us / 1e3 / busy_ms:6.1%}  {family}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3:8.2f} ms  {name[:110]}")
    return busy_ms


def train_inputs(cfg):
    """The training phases' seeded inputs on the card: the two views and
    one masking noise per step."""
    import torch

    rng = np.random.default_rng(21)
    views = [torch.from_numpy(rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32)).cuda()
             for _ in range(2)]
    noise = [torch.from_numpy(rng.random((2 * BATCH, cfg.num_patches)).astype(np.float32)).cuda()
             for _ in range(TRAIN_STEPS)]
    return views, noise


def train_shapes(cfg):
    """The attention shapes (B, H, N, d) of one step: the masked encoder
    over both views (2B rows, the kept patches and cls) and the decoder
    over every token."""
    from vit_ae_plus_plus_torch.configs import TrainConfig

    enc = (2 * BATCH, cfg.num_heads, int(cfg.num_patches * (1 - TrainConfig().mask_ratio)) + 1,
           cfg.embed_dim // cfg.num_heads)
    dec = (BATCH, cfg.decoder_num_heads, cfg.num_patches + 1, cfg.decoder_embed_dim // cfg.decoder_num_heads)
    return enc, dec


def step_launches(cfg, prefix: str, dtype: str) -> dict:
    """The attention launches one training step should make: one forward
    and one backward per block, at the encoder's and the decoder's shape."""
    enc, dec = train_shapes(cfg)
    return {(f"{prefix}_{way}", (*shape, dtype)): depth for way in ("fwd", "bwd")
            for shape, depth in ((enc, cfg.depth), (dec, cfg.decoder_depth))}


def train_phase(rows: list) -> dict:
    """The pretraining step at full width: kernels against plain, launch
    counts per step and by shape, then the per-head path and the f32 path.
    Fills the kernel rows' `launches` from each path's run. -> the default
    path's step-1 metrics and `GRAD_NAMES` gradients (numpy), phase 7's
    reference."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)

    def first_steps(trainer, steps, want_counts):
        before = trainer.model.blocks[0].attn.qkv.weight.detach().clone()
        out, run_counts = [], Counter()
        for i in range(steps):
            metrics, counts = trainer.run(views, noise[i])
            check(counts == want_counts, f"{trainer.label} {trainer.cfg.dtype} step {i + 1} launched "
                  f"{counts} (want {want_counts})")
            run_counts.update(counts)
            out.append((metrics, trainer.grads() if i == 0 else None))
            if i == 0:
                trainer.first_stats = trainer.stats()
            check(trainer.all_grads_finite(), f"{trainer.label} step {i + 1}: non-finite gradients")
        moved = float((trainer.model.blocks[0].attn.qkv.weight.detach() - before).abs().max())
        check(moved > 0, f"{trainer.label}: parameters did not move")
        return out, run_counts

    def hold(label, errs, tol, against="plain"):
        print(f"train {label} vs {against}, step 1 relative errors: "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f" (tol loss terms {tol['loss']}, grads {tol['grad']})", flush=True)
        for k, v in errs.items():
            check(v <= (tol["grad"] if k in FUSED_GRAD_NAMES else tol["loss"]), f"train {label} {k}: rel err {v:.3g}")

    plain = Trainer(tree, stats, "bfloat16", "plain")
    want, _ = first_steps(plain, TRAIN_STEPS, {})
    plain_ms, _ = step_ms(plain, views)
    del plain
    torch.cuda.empty_cache()

    # the main path: three steps, counts set to 0 before each and read after
    auto = Trainer(tree, stats, "bfloat16", "auto")
    auto_step = step_launches(cfg, "packed_flash", "bfloat16")
    got, run_counts = first_steps(auto, TRAIN_STEPS, auto_step)
    fill_launches(rows, run_counts, f"make_train_step, attn_impl='auto', {TRAIN_STEPS} steps")
    tol = STEP_TOL["bfloat16"]
    hold("bf16 auto", step_rel_errs(got[0][0], want[0][0], got[0][1], want[0][1]), tol)
    print("train bf16 losses, steps 1-3: auto " + ", ".join(f"{m['loss']:.6f}" for m, _ in got)
          + "; plain " + ", ".join(f"{m['loss']:.6f}" for m, _ in want), flush=True)
    print(f"train bf16 step 1 metrics (auto): {json.dumps(got[0][0])}", flush=True)
    reference = {"metrics": got[0][0], "grads": {n: g.cpu().numpy() for n, g in got[0][1].items()},
                 "stats": {n: t.numpy() for n, t in auto.first_stats.items()}}

    # the main path timed: the default noise draw, counts read around the run
    resident = reset_peak()
    auto_ms, timed = step_ms(auto, views)
    peak = torch.cuda.max_memory_allocated()
    check(timed == {k: TIMED_STEPS * n for k, n in auto_step.items()},
          f"{TIMED_STEPS} timed auto steps launched {timed}")
    profile_step(auto, views, auto_ms)
    del auto
    torch.cuda.empty_cache()

    flash = Trainer(tree, stats, "bfloat16", "flash")
    [(fm, fgrads)], fcounts = first_steps(flash, 1, step_launches(cfg, "flash", "bfloat16"))
    fill_launches(rows, fcounts, "make_train_step, attn_impl='flash', one step")
    hold("bf16 flash", step_rel_errs(fm, want[0][0], fgrads, want[0][1]), tol)
    flash_ms, _ = step_ms(flash, views, reps=3)
    del flash
    torch.cuda.empty_cache()

    f32 = Trainer(tree, stats, "float32", "auto")
    f32_plain = Trainer(tree, stats, "float32", "plain")
    [(m32, g32)], c32 = first_steps(f32, 1, step_launches(cfg, "packed_flash", "float32"))
    fill_launches(rows, c32, "make_train_step, compute_dtype='float32', one step")
    [(mp, gp)], _ = first_steps(f32_plain, 1, {})
    hold("f32 auto", step_rel_errs(m32, mp, g32, gp), STEP_TOL["float32"])
    reference["float32"] = {"metrics": m32, "grads": {n: g.cpu().numpy() for n, g in g32.items()},
                            "stats": {n: t.numpy() for n, t in f32.first_stats.items()}}
    f32_ms, _ = step_ms(f32, views, reps=2)
    del f32
    torch.cuda.empty_cache()
    f32_flash = Trainer(tree, stats, "float32", "flash")
    [(mf, gf)], cf = first_steps(f32_flash, 1, step_launches(cfg, "flash", "float32"))
    fill_launches(rows, cf, "make_train_step, compute_dtype='float32', attn_impl='flash', one step")
    hold("f32 flash", step_rel_errs(mf, mp, gf, gp), STEP_TOL["float32"])
    del f32_flash, f32_plain
    torch.cuda.empty_cache()

    # the opt-in preset of d = 128 heads, f32: its step with the kernels
    # (the d = 128 backward bodies) against its plain step, same weights
    fast_cfg = MODEL_ZOO[FAST_MODEL](volume_size=VOLUME, patch_size=PATCH)
    fast = preset_trainer(FAST_MODEL, tree, stats, "float32", "auto")
    fast_plain = preset_trainer(FAST_MODEL, tree, stats, "float32", "plain")
    [(m_fast, g_fast)], c_fast = first_steps(fast, 1, step_launches(fast_cfg, "packed_flash", "float32"))
    fill_launches(rows, c_fast, f"make_train_step, {FAST_MODEL}, compute_dtype='float32', one step")
    [(m_fp, g_fp)], _ = first_steps(fast_plain, 1, {})
    hold(f"f32 {FAST_MODEL}", step_rel_errs(m_fast, m_fp, g_fast, g_fp), STEP_TOL["float32"])
    del fast_plain
    torch.cuda.empty_cache()
    fast_ms, fast_timed = step_ms(fast, views, reps=3)
    check(fast_timed == {k: 3 * n for k, n in step_launches(fast_cfg, "packed_flash", "float32").items()},
          f"3 timed {FAST_MODEL} f32 steps launched {fast_timed}")
    print(f"train step {FAST_MODEL} f32, information only ({card_line()}): {fast_ms:.2f} ms per step of {BATCH} "
          f"(CUDA events over 3 steps; {MODEL} f32 {f32_ms:.2f} ms)", flush=True)
    profile_step(fast, views, fast_ms)
    del fast
    torch.cuda.empty_cache()

    # 5b: ln_fusion="on" against "off" from the same start, counts read
    # around every step: the attention launches of the unfused step plus
    # one LayerNorm+Dense forward and backward at qkv and at fc1 per block
    shapes = ln_shapes(cfg)
    trunk = ((shapes["encoder"], shapes["decoder"]), (cfg.depth, cfg.decoder_depth))

    def fused_step(dtype):
        return {**step_launches(cfg, "packed_flash", dtype), **ln_dense_launches(trunk[0], dtype, depths=trunk[1])}

    off = Trainer(tree, stats, "bfloat16", "auto", ln_fusion="off")
    want_off, _ = first_steps(off, TRAIN_STEPS, auto_step)
    del off
    torch.cuda.empty_cache()
    fused = Trainer(tree, stats, "bfloat16", "auto", ln_fusion="on")
    on_step = fused_step("bfloat16")
    got_on, on_counts = first_steps(fused, TRAIN_STEPS, on_step)
    fill_launches(rows, on_counts, f"make_train_step, ln_fusion='on', {TRAIN_STEPS} steps")
    hold("bf16 ln_fusion=on", step_rel_errs(got_on[0][0], want_off[0][0], got_on[0][1], want_off[0][1]),
         FUSED_STEP_TOL, "ln_fusion=off")
    print("train bf16 losses, steps 1-3: ln_fusion=on " + ", ".join(f"{m['loss']:.6f}" for m, _ in got_on)
          + "; off " + ", ".join(f"{m['loss']:.6f}" for m, _ in want_off), flush=True)
    on_resident = reset_peak()
    on_ms, on_timed = step_ms(fused, views)
    on_peak = torch.cuda.max_memory_allocated()
    check(on_timed == {k: TIMED_STEPS * n for k, n in on_step.items()},
          f"{TIMED_STEPS} timed ln_fusion=on steps launched {on_timed}")
    profile_step(fused, views, on_ms)
    del fused
    torch.cuda.empty_cache()

    f32_on = Trainer(tree, stats, "float32", "auto", ln_fusion="on")
    f32_off = Trainer(tree, stats, "float32", "auto", ln_fusion="off")
    [(m_on, g_on)], c_on = first_steps(f32_on, 1, fused_step("float32"))
    fill_launches(rows, c_on, "make_train_step, compute_dtype='float32', ln_fusion='on', one step")
    [(m_off, g_off)], _ = first_steps(f32_off, 1, step_launches(cfg, "packed_flash", "float32"))
    hold("f32 ln_fusion=on", step_rel_errs(m_on, m_off, g_on, g_off), STEP_TOL["float32"], "ln_fusion=off")
    # both f32 steps timed in turns (on, off, on, off: a step's wall time
    # moves more between runs than its device time does) and profiled:
    # where the f32 step's device time goes
    f32_turns = {"on": [], "off": []}
    for which, trainer in (("on", f32_on), ("off", f32_off), ("on", f32_on), ("off", f32_off)):
        t_ms, timed = step_ms(trainer, views, reps=3)
        f32_turns[which].append(t_ms)
        want_timed = fused_step("float32") if which == "on" else step_launches(cfg, "packed_flash", "float32")
        check(timed == {k: 3 * n for k, n in want_timed.items()}, f"3 timed f32 ln_fusion={which} steps launched {timed}")
    f32_on_ms, f32_off_ms = f32_turns["on"][-1], f32_turns["off"][-1]
    profile_step(f32_on, views, f32_on_ms)
    profile_step(f32_off, views, f32_off_ms)
    del f32_on, f32_off
    torch.cuda.empty_cache()

    # each kernel's time at its shape, times its launches in one step
    ms = {(row["name"], row["key"]): row["ms"] for row in rows}
    attn_ms = sum(n * ms[k] for k, n in auto_step.items())
    lnd_ms = sum(n * ms[k] for k, n in on_step.items() if k[0].startswith("ln_dense"))
    lnd32_ms = sum(n * ms[k] for k, n in fused_step("float32").items() if k[0].startswith("ln_dense"))
    card = card_line()
    print(f"train step, information only ({card}): bf16 auto {auto_ms:.2f} ms per step of {BATCH} "
          f"(CUDA events over {TIMED_STEPS} steps), {BATCH / auto_ms * 1e3:.1f} volumes/s, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({resident / 2**30:.2f} before the steps); attention kernels {cfg.depth} x (enc fwd+bwd) + "
          f"{cfg.decoder_depth} x (dec fwd+bwd) = {attn_ms:.2f} ms = {attn_ms / auto_ms:.1%} of the step; "
          f"bf16 plain {plain_ms:.2f} ms, bf16 flash {flash_ms:.2f} ms, f32 auto {f32_ms:.2f} ms", flush=True)
    print(f"train step ln_fusion=on, information only ({card}): bf16 {on_ms:.2f} ms per step of {BATCH} "
          f"({BATCH / on_ms * 1e3:.1f} volumes/s; auto {auto_ms:.2f} ms), max_memory_allocated "
          f"{on_peak / 2**30:.2f} GiB ({on_resident / 2**30:.2f} before the steps; auto {peak / 2**30:.2f}); LayerNorm+Dense kernels, 40 forward + 40 "
          f"backward = {lnd_ms:.2f} ms = {lnd_ms / on_ms:.1%} of the step", flush=True)
    print(f"train step f32, information only ({card}): ln_fusion=on {f32_turns['on'][0]:.2f}, {f32_on_ms:.2f} ms, "
          f"off {f32_turns['off'][0]:.2f}, {f32_off_ms:.2f} ms per step of {BATCH} (CUDA events over 3 steps, two "
          f"rounds in turns); f32 LayerNorm+Dense kernels, 40 forward + 40 backward = {lnd32_ms:.2f} ms = "
          f"{lnd32_ms / f32_on_ms:.1%} of the fused step", flush=True)
    return reference


def mean_max(values) -> str:
    return f"mean {np.mean(values):.2f}, max {np.max(values):.2f}"


def write_brats_input(tmp: Path) -> Path:
    """Phase 5c's data: seeded volumes in the disk layout (N, S, S, S, C)
    with balanced labels, split by the port's `prepare-data brats`; the
    split files' names and shapes checked, and x_whole against the input.
    -> the split directory."""
    from vit_ae_plus_plus_torch.cli import main as cli_main

    rng = np.random.default_rng(DATA_SEED)
    vols = rng.standard_normal((DATA_VOLUMES, VOLUME, VOLUME, VOLUME, 1), dtype=np.float32)
    labels = np.arange(DATA_VOLUMES) % 2
    np.save(tmp / "flair_all.npy", vols)
    np.save(tmp / "label_all.npy", labels)
    out = tmp / "splits"
    check(cli_main(["prepare-data", "brats", "--volumes", str(tmp / "flair_all.npy"),
                    "--labels", str(tmp / "label_all.npy"), "--out-dir", str(out)]) == 0, "prepare-data brats")
    # stratified 90/10 twice: 43 + 5, then 38 + 5
    sizes = {"train": 38, "val": 5, "test": 5, "whole": DATA_VOLUMES}
    want = {f"x_{m}_ssl.npy": (n, VOLUME, VOLUME, VOLUME, 1) for m, n in sizes.items()}
    want.update({f"y_{m}_ssl.npy": (n,) for m, n in sizes.items()})
    want.update({f"{m}_indices.npy": (n,) for m, n in sizes.items() if m != "whole"})
    got = {p.name: np.load(p, mmap_mode="r").shape for p in out.iterdir()}
    check(got == want, f"prepare-data wrote {got} (want {want})")
    check(np.array_equal(np.load(out / "x_whole_ssl.npy", mmap_mode="r"), vols), "x_whole_ssl.npy != the input")
    check(np.array_equal(np.load(out / "y_whole_ssl.npy"), labels), "y_whole_ssl.npy != the labels")
    return out


def data_phase(tmp: Path) -> tuple:
    """Phase 5c: the host data path feeds the step. The port's
    `prepare-data brats` splits a synthetic input in `tmp`; `get_dataset`
    with the native augmenter (`native="require"`) and z-score,
    `Loader(batch_size=8, shuffle, drop_last, 8 threads)` and
    `cuda_prefetch(size=2)` feed phase 5's full-width step (attn_impl
    "auto", TrainConfig's defaults): one warm-up and 5 timed steps in f32,
    then in bf16, each against the resident-views step of phase 5 on the
    same trainer. Checks: the first batch on the card is its numpy batch
    bitwise, the staging buffers are pinned, every metric is finite, and
    each step launches phase 5's attention kernels by shape. -> the split
    directory, and by dtype the loader-fed and the resident-views step ms."""
    import torch

    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
    from vit_ae_plus_plus_torch.data import native_augment as na
    from vit_ae_plus_plus_torch.data.loader import cuda_prefetch
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    t0 = time.perf_counter()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, _ = train_inputs(cfg)
    card = card_line()
    step_times = {}
    split_dir = write_brats_input(tmp)
    policy = default_ssl_transforms(native="require")
    check(isinstance(policy.transforms[0], na.NativeRandomAffine3D), f"not the native policy: {policy}")
    dataset = get_dataset("brats", "whole", DataConfig(base_path=str(split_dir)), transforms=policy,
                          use_z_score=True)
    print(f"data phase: prepare-data brats on {DATA_VOLUMES} volumes of {VOLUME}^3 in "
          f"{time.perf_counter() - t0:.1f}s; policy {[type(t).__name__ for t in policy.transforms]}", flush=True)
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(tree, stats, dtype, "auto")
        want_step = step_launches(cfg, "packed_flash", dtype)
        loader = Loader(dataset, batch_size=BATCH, shuffle=True, drop_last=True, seed=0, num_workers=8)
        check(len(loader) == 1 + TIMED_STEPS, f"{len(loader)} batches an epoch")
        first = []

        def keep_first(batches):
            for batch in batches:
                if not first:
                    first.append((batch[0].copy(), batch[1].copy()))
                yield batch

        record = {}
        fed = cuda_prefetch(keep_first(loader), size=2, record=record)

        pulls, calls = [], []

        def fed_step():
            t_pull = time.perf_counter()
            aug, orig, _ = next(fed)
            pulls.append((time.perf_counter() - t_pull) * 1e3)
            reset_launch_counts()
            t_call = time.perf_counter()
            trainer.state, metrics = trainer.step(trainer.state, aug, orig, trainer.emw)
            calls.append((time.perf_counter() - t_call) * 1e3)
            counts = shape_counts()
            check(counts == want_step, f"{dtype} loader-fed step launched {counts} (want {want_step})")
            return aug, orig, metrics

        aug, orig, metrics = fed_step()
        for name, dev, host in (("aug", aug, first[0][0]), ("orig", orig, first[0][1])):
            check(np.array_equal(dev.cpu().numpy(), host), f"{dtype}: the first batch's {name} on the "
                  "card differs from its numpy batch")
        all_metrics = [metrics]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMED_STEPS):
            all_metrics.append(fed_step()[2])
        end.record()
        torch.cuda.synchronize()
        fed_ms = start.elapsed_time(end) / TIMED_STEPS
        check(next(fed, None) is None, "the loader yielded more than one epoch's batches")
        buffers = [b for ring in record["staging"].values() for b in ring if b is not None]
        check(len(buffers) == 2 * 3 and all(b.is_pinned() for b in buffers),
              f"staging buffers: {[(tuple(b.shape), b.is_pinned()) for b in buffers]}")
        for i, m in enumerate(all_metrics):
            m = {k: float(v) for k, v in m.items()}
            check(all(np.isfinite(v) for v in m.values()), f"{dtype} loader-fed step {i + 1}: {m}")
        collate, wait, pull, call = list(loader.collate_ms), list(loader.wait_ms), pulls[1:], calls[1:]
        h2d = [s.elapsed_time(e) for s, e in record["copies"]]
        resident_ms, timed = step_ms(trainer, views)
        check(timed == {k: TIMED_STEPS * n for k, n in want_step.items()}, f"resident steps launched {timed}")
        # the host's time to issue a step on resident views, no loader running
        resident_calls = []
        for _ in range(TIMED_STEPS):
            t_call = time.perf_counter()
            trainer.state, _ = trainer.step(trainer.state, *views, trainer.emw)
            resident_calls.append((time.perf_counter() - t_call) * 1e3)
        torch.cuda.synchronize()
        # one more loader-fed step, from the next epoch, under the profiler
        fed = cuda_prefetch(loader, size=2)
        busy = profile_run(fed_step, f"{dtype} loader-fed step", fed_ms)
        fed.close()
        mb = 2 * BATCH * VOLUME**3 * 4 / 1e6
        print(f"data path {dtype} ({card}): loader-fed step {fed_ms:.2f} ms, resident views {resident_ms:.2f} "
              f"ms per step of {BATCH} (CUDA events over {TIMED_STEPS} steps after one warm-up; "
              f"{BATCH / fed_ms * 1e3:.1f} vs {BATCH / resident_ms * 1e3:.1f} volumes/s); device idle "
              f"{1 - busy / fed_ms:.1%} of a loader-fed step", flush=True)
        print(f"data path {dtype} host ({card}): collate ms per batch {mean_max(collate)} "
              f"(8 threads, native augmenter, {len(collate)} batches); consumer wait on the queue ms "
              f"per step {mean_max(wait)}; the step loop's host ms in `next` (queue wait, pinned "
              f"staging copy, copy launch) over the timed steps {mean_max(pull)}; H2D ms per batch of "
              f"aug + orig ({mb:.1f} MB) {mean_max(h2d)} (events on the side stream); host ms to issue "
              f"a step, loader-fed {mean_max(call)}, resident views {mean_max(resident_calls)}", flush=True)
        step_times[dtype] = {"fed": fed_ms, "resident": resident_ms}
        del trainer, fed
        gc.collect()
        torch.cuda.empty_cache()
    print(f"data phase {time.perf_counter() - t0:.1f}s", flush=True)
    return split_dir, step_times


def run_cli(argv: list, label: str) -> tuple:
    """The port's CLI `main(argv)` in this process, its prints captured, with
    the launch counts set to 0 just before and read just after. Fails unless
    it exits 0. -> (its last printed line, wall seconds, launches by
    (wrapper, shape))."""
    from vit_ae_plus_plus_torch.cli import main as cli_main
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts

    out = io.StringIO()
    reset_launch_counts()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_main(argv)
    except BaseException:
        print("\n".join(out.getvalue().splitlines()[-20:]), file=sys.stderr)
        raise
    wall = time.perf_counter() - t
    counts = shape_counts()
    printed = out.getvalue().strip().splitlines()
    check(rc == 0, f"{label} exit {rc}: " + "\n".join(printed[-20:]))
    return printed[-1], wall, counts


def pretrain_phase(split_dir: Path, step_times: dict) -> Path:
    """Phase 5d: the port's `pretrain-kfold` command on phase 5c's split
    directory (48 volumes of 96^3): 2 folds of 24 training volumes, 3 epochs
    of 3 steps at batch 8, then 3 extraction slabs each of the fold's train
    and test volumes; once in f32 and once in the command's default bf16.
    Checks: exit 0; the fold index files partition the volumes, 12 of each
    label in each test fold; `log.txt` has 6 finite rows; each fold's
    `checkpoint-min_loss.pth` loads through `load_reference_state_dict`;
    each features file is (24, 768) f32 and finite, its labels y_whole at
    the sorted ids; the attention launches by shape are 18 steps of phase
    5's plus 12 slabs of 12 at the features' shape; fold 0's test features
    recomputed from its `.pth` with attn_impl="plain" lie within
    ENGINE_TOL. Prints, beside the card: each epoch's ms per step and
    volumes/s from `log.txt` (the epoch's wall time, first batch included)
    against phase 5c's step times, the min-loss `.pth` writes, extraction ms
    per slab and each fold's wall time. -> the bf16 run's work dir, which
    phase 5e reads."""
    import torch

    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.data import get_dataset
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as pk
    from vit_ae_plus_plus_torch.serving import FeatureEngine
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    t0 = time.perf_counter()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    folds, epochs, fold_train = 2, 3, DATA_VOLUMES // 2
    steps_per_epoch, slabs = fold_train // BATCH, fold_train // BATCH
    labels = np.load(split_dir / "y_whole_ssl.npy")
    plain_ds = get_dataset("brats", "whole", DataConfig(base_path=str(split_dir)), transforms=None, use_z_score=True)
    card = card_line()
    real = {name: getattr(pk, name) for name in ("pretrain_one_fold", "extract_fold_features", "save_state_dict",
                                                  "cuda_prefetch")}
    for dtype in ("float32", "bfloat16"):
        work = split_dir.parent / f"pretrain_{dtype}"
        argv = ["pretrain-kfold", "--data-path", str(split_dir), "--work-dir", str(work), "--model", MODEL,
                "--volume-size", str(VOLUME), "--patch-size", str(PATCH), "--batch-size", str(BATCH),
                "--epochs", str(epochs), "--n-splits", str(folds)]
        if dtype == "float32":
            argv += ["--compute-dtype", "float32"]
        else:  # phase 5j reads its profiled epoch and its fold-0 resume file
            argv += ["--profile-dir", str(work / "profile"), "--resume", "--ckpt-every", str(epochs)]
        fold_start, fold_end, extract_ms, writes, fills = {}, {}, [], [], []

        def pretrain_one_fold(fold_idx, *args, **kwargs):
            fold_start[fold_idx] = time.perf_counter()
            return real["pretrain_one_fold"](fold_idx, *args, **kwargs)

        def extract_fold_features(*args, **kwargs):
            t = time.perf_counter()
            real["extract_fold_features"](*args, **kwargs)  # ends in a copy to the host
            extract_ms.append((time.perf_counter() - t) * 1e3)
            fold_end[args[7]] = time.perf_counter()

        def save_state_dict(path, state_dict):
            t = time.perf_counter()
            real["save_state_dict"](path, state_dict)
            writes.append(((time.perf_counter() - t) * 1e3, os.path.getsize(path)))

        def cuda_prefetch(loader, *args, **kwargs):
            # a training epoch's wait for its first batch on the card: the
            # loader's start and the prefetch's fill of `size` batches
            t = time.perf_counter()
            for i, batch in enumerate(real["cuda_prefetch"](loader, *args, **kwargs)):
                if i == 0 and kwargs.get("put_orig", True):
                    fills.append((time.perf_counter() - t) * 1e3)
                yield batch

        for name, fn in (("pretrain_one_fold", pretrain_one_fold), ("extract_fold_features", extract_fold_features),
                         ("save_state_dict", save_state_dict), ("cuda_prefetch", cuda_prefetch)):
            setattr(pk, name, fn)
        try:
            last, run_s, counts = run_cli(argv, f"pretrain-kfold {dtype}")
        finally:
            for name, fn in real.items():
                setattr(pk, name, fn)
        results = json.loads(last)
        check(sorted(results) == ["0", "1"] and all(np.isfinite(r["min_loss"]) for r in results.values()),
              f"pretrain-kfold {dtype} results {results}")

        index_dir = work / "k_fold" / "indices_file"
        ids = {(s, k): np.load(index_dir / f"{s}_{k}.npy") for s in ("train", "test") for k in range(folds)}
        for k in range(folds):
            both = np.concatenate([ids[("train", k)], ids[("test", k)]])
            check(sorted(both.tolist()) == list(range(DATA_VOLUMES)) and len(ids[("test", k)]) == fold_train
                  and int(labels[ids[("test", k)]].sum()) == fold_train // 2, f"fold {k} index files")
        with open(work / "checkpoints" / "log.txt") as f:
            rows = [json.loads(line) for line in f]
        check([(r["fold"], r["epoch"]) for r in rows] == [(k, e) for k in range(folds) for e in range(epochs)]
              and all(np.isfinite(v) for r in rows for v in r.values()), f"{dtype} log.txt rows {rows}")
        for k in range(folds):
            sd = load_reference_state_dict(str(work / "checkpoints" / f"fold_{k}" / "checkpoint-min_loss.pth"))
            check(sd["blocks.0.attn.qkv.weight"].dtype == torch.float32, f"fold {k} checkpoint")
            for tag in ("train", "test"):
                feats = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_features_split_{k}.npy")
                labs = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_labels_split_{k}.npy")
                check(feats.shape == (fold_train, cfg.embed_dim) and feats.dtype == np.float32
                      and bool(np.isfinite(feats).all()), f"{dtype} fold {k} {tag} features {feats.shape}")
                check(np.array_equal(labs, labels[np.sort(ids[(tag, k)])]), f"{dtype} fold {k} {tag} labels")

        steps = folds * epochs * steps_per_epoch
        want = {key: steps * n for key, n in step_launches(cfg, "packed_flash", dtype).items()}
        slab_key = ("packed_flash_fwd", (BATCH, cfg.num_heads, cfg.num_patches + 1,
                                         cfg.embed_dim // cfg.num_heads, dtype))
        want[slab_key] = want.get(slab_key, 0) + folds * 2 * slabs * cfg.depth
        check(counts == want, f"pretrain-kfold {dtype} launched {counts} (want {want})")

        test_ids = np.sort(ids[("test", 0)])
        engine = FeatureEngine(str(work / "checkpoints" / "fold_0" / "checkpoint-min_loss.pth"), model_name=MODEL,
                               volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH, compute_dtype=dtype,
                               attn_impl="plain")
        ref = engine.infer(np.stack([plain_ds[int(i)][0] for i in test_ids]))
        err = rel_err(np.load(work / "ssl_features_dir" / "test_contrast_ssl_features_split_0.npy"), ref)
        check(err <= ENGINE_TOL[dtype], f"{dtype} fold 0 test features vs plain from the .pth: rel err {err:.3g}")
        del engine

        ms = [1e3 * BATCH / r["train_volumes_per_sec"] for r in rows]
        later = [m for r, m in zip(rows, ms) if r["epoch"] >= 1]
        print(f"pretrain-kfold {dtype} ({card}): exit 0 in {run_s:.1f}s; ms per step by (fold, epoch) "
              + ", ".join(f"({r['fold']}, {r['epoch']}) {m:.2f}" for r, m in zip(rows, ms))
              + f"; epochs >= 1 {mean_max(later)} ms, {BATCH / np.mean(later) * 1e3:.1f} volumes/s (the epoch's "
              f"wall time over its {steps_per_epoch} steps, loader start included); an epoch's wait for its "
              f"first batch {mean_max(fills)} ms; phase 5c: loader-fed "
              f"{step_times[dtype]['fed']:.2f} ms, resident views {step_times[dtype]['resident']:.2f} ms; "
              f"{steps} steps, {folds * 2 * slabs} slabs", flush=True)
        print(f"pretrain-kfold {dtype} ({card}): min-loss .pth writes {len(writes)}, ms "
              + ", ".join(f"{w:.1f}" for w, _ in writes) + f", {writes[0][1] / 1e6:.1f} MB each; extraction ms "
              f"per slab (a call's wall time over its {slabs} slabs, graft and loader start included) "
              + ", ".join(f"{e / slabs:.2f}" for e in extract_ms) + "; fold wall s "
              + ", ".join(f"{fold_end[k] - fold_start[k]:.2f}" for k in range(folds))
              + f"; fold 0 test features vs plain from the .pth rel err {err:.3g} (tol {ENGINE_TOL[dtype]})",
              flush=True)
        if dtype == "float32":
            shutil.rmtree(work)  # two min-loss files of about 450 MB each
        gc.collect()
        torch.cuda.empty_cache()
    print(f"pretrain phase {time.perf_counter() - t0:.1f}s", flush=True)
    return work


def vit_attention_shape() -> tuple:
    """(B, H, N, d) of the classifier ViT's attention, every token of a slab
    (B8 H12 N1729 d64 for ViT-B at 96^3 / patch 8), and its depth: the
    launches of each kernel in one pass."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    return (BATCH, cfg.num_heads, cfg.num_patches + 1, cfg.embed_dim // cfg.num_heads), cfg.depth


def slabs(n: int) -> int:
    """Slabs of BATCH that n volumes take, the last one padded."""
    return -(-n // BATCH)


def check_eval_stats(results: dict, label: str) -> None:
    """Each best model's test stats: AUC, specificity and sensitivity finite
    in [0, 1] (the tiny sets make their values meaningless), loss finite."""
    for name, stats in results.items():
        check(all(np.isfinite(stats[k]) and 0.0 <= stats[k] <= 1.0 for k in FT_METRICS)
              and np.isfinite(stats["loss"]), f"{label} {name} test stats {stats}")


def best_files(work: Path, fold=None) -> list:
    """The best-model checkpoints a run wrote (of a fold, or of the single
    run), each loaded as a reference-layout classifier state dict."""
    from vit_ae_plus_plus_torch.pipelines.finetune import BestModelTracker
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    tracker = BestModelTracker(str(work / "checkpoints"))
    names = [n for n in tracker.names if os.path.exists(tracker.path(n, fold))]
    for n in names:
        sd = load_reference_state_dict(tracker.path(n, fold))
        check(sd["head.weight"].shape[0] == 2, f"{work.name} {n} fold {fold}: head {sd['head.weight'].shape}")
    return names


class FineTuner:
    """One classifier of the fine-tune path, through the port's public API:
    the MAE `.pth` grafted into the classifier ViT (`build_grafted_vit`),
    `head_init_2e5`, layer-wise AdamW (or the frozen backbone's SGD),
    `create_train_state` and `make_supervised_steps`."""

    def __init__(self, mae_sd, dtype: str, attn_impl: str = "auto", frozen: bool = False, mixup: bool = False):
        import torch

        from vit_ae_plus_plus_torch.models import MODEL_ZOO
        from vit_ae_plus_plus_torch.pipelines.finetune import head_init_2e5, make_supervised_steps
        from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
        from vit_ae_plus_plus_torch.train import create_train_state
        from vit_ae_plus_plus_torch.train.optim import freeze_backbone_tx, make_layerwise_adamw, make_sgd

        mae_cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH, dtype=dtype, attn_impl=attn_impl)
        vit_cfg = mae_cfg.encoder_vit_config(num_classes=2)
        self.model = build_grafted_vit(mae_sd, mae_cfg, vit_cfg, torch.device("cuda"))
        head_init_2e5(self.model, torch.Generator().manual_seed(49))
        # a constant learning rate above 0: the fine-tune warmup's first is 0
        tx = freeze_backbone_tx(make_sgd(1e-3)) if frozen else make_layerwise_adamw(vit_cfg.depth, 1e-4)
        self.state = create_train_state(self.model, tx)
        self.train_step, self.eval_step = make_supervised_steps(self.model, num_classes=2, use_mixup=mixup)

    def run(self, batch, labels):
        """One step, counts read around it. -> (loss, the FT_GRAD_NAMES
        gradients of trained parameters, launches by (wrapper, shape))."""
        import torch

        from vit_ae_plus_plus_torch.kernels import reset_launch_counts

        reset_launch_counts()
        self.state, metrics = self.train_step(self.state, batch, labels, 0)
        loss = float(metrics["loss"])
        counts = shape_counts()
        named = dict(self.model.named_parameters())
        check(np.isfinite(loss) and all(bool(torch.isfinite(p.grad).all()) for p in self.state.tx.params),
              f"fine-tune step: loss {loss} or a gradient not finite")
        return loss, {n: named[n].grad.float().clone() for n in FT_GRAD_NAMES if named[n].requires_grad}, counts


def finetune_step_checks(mae_sd, rows: list) -> None:
    """Phase 5e's full-width steps: one fine-tune step with the kernels
    against one with attn_impl="plain" from the same weights and batch (of
    one class, see FT_GRAD_NAMES), in bf16 and in f32 (loss and
    FT_GRAD_NAMES gradients within STEP_TOL; 12 packed forward and 12 packed
    backward launches at B8 H12 N1729 d64); one bf16 step with
    attn_impl="flash" against the same plain step (12 + 12 per-head
    launches). Then, as information: the same with both classes in the
    batch, beside the plain step on the batch reversed; ms per fine-tune
    step (bf16, f32) and volumes/s, ms per probe step (frozen backbone,
    bf16: 12 forward launches and no backward), evaluation ms per slab, and
    each step's peak memory."""
    import torch

    rng = np.random.default_rng(61)
    batch = torch.from_numpy(rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME), dtype=np.float32)).cuda()
    one_class = torch.ones(BATCH, dtype=torch.int64, device="cuda")
    balanced = torch.tensor([0, 1] * (BATCH // 2), device="cuda")
    key, depth = vit_attention_shape()
    card = card_line()
    times, peak = {}, {}

    def errs_line(errs: dict) -> str:
        return ", ".join(f"{k} {e:.3g}" for k, e in errs.items())

    for dtype in ("bfloat16", "float32"):
        tol = STEP_TOL[dtype]
        plain_loss, plain_grads, counts = FineTuner(mae_sd, dtype, "plain").run(batch, one_class)
        check(totals(counts) == NO_LAUNCHES, f"plain {dtype} fine-tune step launched {totals(counts)}")
        for impl in ("auto", "flash") if dtype == "bfloat16" else ("auto",):
            base = reset_peak()
            tuner = FineTuner(mae_sd, dtype, impl)
            loss, grads, counts = tuner.run(batch, one_class)
            prefix = "packed_flash" if impl == "auto" else "flash"
            want = {(f"{prefix}_{way}", (*key, dtype)): depth for way in ("fwd", "bwd")}
            check(counts == want, f"fine-tune {dtype} {impl} step launched {counts} (want {want})")
            fill_launches(rows, counts, f"one full-width fine-tune step, {dtype}, attn_impl='{impl}'")
            errs = step_rel_errs({"loss": loss}, {"loss": plain_loss}, grads, plain_grads)
            bad = {k: e for k, e in errs.items() if e > (tol["loss"] if k == "loss" else tol["grad"])}
            print(f"fine-tune step {dtype} {impl} vs plain: {errs_line(errs)} (tol loss {tol['loss']}, "
                  f"grads {tol['grad']})", flush=True)
            check(not bad, f"fine-tune step {dtype} {impl} vs plain: {bad}")
            if impl == "auto":
                times[dtype] = cuda_ms(lambda: tuner.train_step(tuner.state, batch, one_class, 0), reps=3, warmup=1)
                peak[dtype] = (torch.cuda.max_memory_allocated() - base) / 2**30
                if dtype == "bfloat16":
                    times["eval"] = cuda_ms(lambda: tuner.eval_step(batch, one_class), reps=5)
            del tuner
        runs = {name: FineTuner(mae_sd, dtype, impl).run(*args)
                for name, impl, args in (("plain", "plain", (batch, balanced)), ("kernels", "auto", (batch, balanced)),
                                         ("reversed", "plain", (batch.flip(0), balanced.flip(0))))}
        (want_loss, want_grads, _) = runs.pop("plain")
        print(f"fine-tune step {dtype}, both classes in the batch, information: " + "; ".join(
            f"{name} vs plain {errs_line(step_rel_errs({'loss': l}, {'loss': want_loss}, g, want_grads))}"
            for name, (l, g, _) in runs.items()), flush=True)
    probe = FineTuner(mae_sd, "bfloat16", frozen=True)
    _, _, counts = probe.run(batch, balanced)
    want = {("packed_flash_fwd", (*key, "bfloat16")): depth}
    check(counts == want, f"probe step launched {counts} (want {want}: no backward)")
    times["probe"] = cuda_ms(lambda: probe.train_step(probe.state, batch, balanced, 0), reps=5)
    del probe
    reset_peak()
    print(f"fine-tune steps ({card}, CUDA events, batch {BATCH}): bf16 {times['bfloat16']:.2f} ms "
          f"({BATCH / times['bfloat16'] * 1e3:.1f} volumes/s), f32 {times['float32']:.2f} ms "
          f"({BATCH / times['float32'] * 1e3:.1f} volumes/s); probe step (frozen backbone, bf16) "
          f"{times['probe']:.2f} ms; evaluation bf16 {times['eval']:.2f} ms per slab; peak memory above the "
          f"weights' start bf16 {peak['bfloat16']:.2f} GiB, f32 {peak['float32']:.2f} GiB", flush=True)


class Spans:
    """Host seconds spent in the port's functions that `patches` names
    ((module, attribute, span)) while installed. Each span waits for the
    card at its end, so it holds its own work."""

    def __init__(self, patches):
        self.patches, self.seconds, self.calls = patches, Counter(), Counter()

    def __enter__(self):
        self.real = [(module, attr, getattr(module, attr)) for module, attr, _ in self.patches]
        for (module, attr, span), (_, _, fn) in zip(self.patches, self.real):
            setattr(module, attr, self._timed(fn, span))
        return self

    def _timed(self, fn, span):
        import torch

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.seconds[span] += time.perf_counter() - t
                self.calls[span] += 1
        return timed

    def __exit__(self, *exc):
        for module, attr, fn in self.real:
            setattr(module, attr, fn)

    def line(self, wall: float) -> str:
        """`wall` split into the spans and the rest."""
        spans = dict.fromkeys(span for _, _, span in self.patches)
        parts = [f"{span} {self.seconds[span]:.2f} s ({self.calls[span]} calls)" for span in spans
                 if self.calls[span]]
        return f"wall {wall:.2f} s: " + ", ".join(parts) + f", rest {wall - sum(self.seconds.values()):.2f} s"


def downstream_phase(split_dir: Path, pre_work: Path, rows: list) -> None:
    """Phase 5e: the port's downstream commands on phase 5d's bf16 work dir
    and phase 5c's split, at batch 8, each through `run_cli` with the counts
    read around it:
    - `extract-features` from fold 0's min-loss `.pth` (bf16): the train
      and test features (38 and 5, 768, f32, finite) with their labels,
      the test features against the same `.pth` run with
      attn_impl="plain" within ENGINE_TOL, 12 forward launches a slab;
    - `probe-kfold` (frozen backbone, bf16), 2 folds of 2 epochs: packed
      forward launches only, 12 for each step and each evaluation slab,
      and no backward;
    - `finetune-kfold` (bf16) and `finetune` (f32, fold 0's `.pth`): 12
      forward and 12 backward launches a step at B8 H12 N1729 d64, 12
      forward an evaluation slab;
    each: its best-model `.pth` files and its test stats finite in [0, 1].
    Then `finetune_step_checks`. Prints, beside the card, each command's
    wall time and where it went: training epochs (loader included),
    evaluation, best-model writes, the graft, the rest."""
    import torch

    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.data import get_dataset
    from vit_ae_plus_plus_torch.data.splits import train_test_split
    from vit_ae_plus_plus_torch.pipelines import finetune as ft
    from vit_ae_plus_plus_torch.pipelines import probe_kfold as pkf
    from vit_ae_plus_plus_torch.serving import FeatureEngine
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    t0 = time.perf_counter()
    card = card_line()
    folds, epochs = 2, 2
    pth = pre_work / "checkpoints" / "fold_0" / "checkpoint-min_loss.pth"
    common = ["--data-path", str(split_dir), "--model", MODEL, "--volume-size", str(VOLUME), "--patch-size",
              str(PATCH), "--batch-size", str(BATCH), "--epochs", str(epochs), "--n-splits", str(folds)]
    n = {m: len(np.load(split_dir / f"y_{m}_ssl.npy")) for m in ("train", "val", "test")}
    shape, depth = vit_attention_shape()
    spans = [(ft, "train_one_epoch", "training epochs"), (pkf, "train_one_epoch", "training epochs"),
             (ft, "evaluate", "evaluation"), (pkf, "evaluate", "evaluation"),
             (ft, "save_state_dict", "best-model writes"),
             (ft, "build_classifier", "graft"), (pkf, "build_classifier", "graft")]

    # extract-features
    work = split_dir.parent / "features"
    last, wall, counts = run_cli(
        ["extract-features", *common, "--work-dir", str(work), "--checkpoint", str(pth)], "extract-features")
    check(last == "done", f"extract-features printed {last!r}")
    want = {("packed_flash_fwd", (*shape, "bfloat16")): depth * (slabs(n["train"]) + slabs(n["test"]))}
    check(counts == want, f"extract-features launched {counts} (want {want})")
    for split in ("train", "test"):
        feats, labs = np.load(work / f"{split}_features.npy"), np.load(work / f"{split}_gt_labels.npy")
        check(feats.shape == (n[split], shape[1] * shape[3]) and feats.dtype == np.float32
              and bool(np.isfinite(feats).all()), f"extract-features {split} features {feats.shape} {feats.dtype}")
        check(np.array_equal(labs, np.load(split_dir / f"y_{split}_ssl.npy")), f"extract-features {split} labels")
    test_ds = get_dataset("brats", "test", DataConfig(base_path=str(split_dir)), transforms=None, use_z_score=True)
    engine = FeatureEngine(str(pth), model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH,
                           attn_impl="plain")
    ref = engine.infer(np.stack([test_ds[i][0] for i in range(len(test_ds))]))
    del engine
    feat_err = rel_err(np.load(work / "test_features.npy"), ref)
    check(feat_err <= ENGINE_TOL["bfloat16"], f"extract-features test features vs plain: rel err {feat_err:.3g}")
    print(f"downstream extract-features bf16 ({card}): wall {wall:.2f} s for "
          f"{slabs(n['train']) + slabs(n['test'])} slabs (graft and loader start included); test features vs "
          f"plain from the .pth rel err {feat_err:.3g} (tol {ENGINE_TOL['bfloat16']})", flush=True)

    # probe-kfold and finetune-kfold in bf16, finetune in f32
    runs = (("probe-kfold", "bfloat16", ["--pretrain-dir", str(pre_work)]),
            ("finetune-kfold", "bfloat16", ["--pretrain-dir", str(pre_work)]),
            ("finetune", "float32", ["--checkpoint", str(pth), "--compute-dtype", "float32"]))
    for cmd, dtype, extra in runs:
        work = split_dir.parent / cmd
        base = reset_peak()
        with Spans(spans) as timed:
            last, wall, counts = run_cli([cmd, *common, "--work-dir", str(work), *extra], f"{cmd} {dtype}")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        results = json.loads(last)
        if cmd == "finetune":  # one run over the train / val / test splits
            results, sets = {"0": results}, [(n["train"], n["val"], n["test"], None)]
        else:
            sets = []
            for k in range(folds):
                ids = {s: np.load(work / "k_fold" / "indices_file" / f"{s}_{k}.npy") for s in ("train", "test")}
                train_ids, val_ids = train_test_split(ids["train"], test_size=0.20, random_state=42)
                sets.append((len(train_ids), len(val_ids), len(ids["test"]), k))
        check(sorted(results) == [str(k) for k in range(len(sets))], f"{cmd} results {results}")
        steps = evals = 0
        for i, (n_train, n_val, n_test, fold) in enumerate(sets):
            names = best_files(work, fold)
            check(sorted(results[str(i)]) == sorted(names) and names, f"{cmd} {i}: {results[str(i)]}, files {names}")
            check_eval_stats(results[str(i)], f"{cmd} {i}")
            steps += epochs * (n_train // BATCH)
            evals += epochs * (slabs(n_train) + slabs(n_val)) + len(names) * slabs(n_test)
        want = {("packed_flash_fwd", (*shape, dtype)): depth * (steps + evals)}
        if cmd != "probe-kfold":
            want[("packed_flash_bwd", (*shape, dtype))] = depth * steps
        check(counts == want, f"{cmd} {dtype} launched {counts} (want {want})")
        fill_launches(rows, counts, f"{cmd} ({dtype}, {len(sets)} x {epochs} epochs of "
                                    f"{steps // (len(sets) * epochs)} steps, batch 8)")
        with open(work / "log.txt") as f:
            logged = [json.loads(line) for line in f]
        check(len(logged) == len(sets) * epochs and all(np.isfinite(r["val_loss"]) for r in logged),
              f"{cmd} log.txt")
        print(f"downstream {cmd} {dtype} ({card}): {timed.line(wall)}; {steps} steps, {evals} evaluation slabs; "
              f"peak memory above its start {peak:.2f} GiB", flush=True)
        shutil.rmtree(work)

    finetune_step_checks(load_reference_state_dict(str(pth)), rows)
    print(f"downstream phase {time.perf_counter() - t0:.1f}s", flush=True)


RESNET_DEPTH, RESNET_GATE_BATCH = 10, 4


@contextlib.contextmanager
def tf32_convolutions():
    """The TF32 control of phase 5f: the port's ResNet with its
    `conv_precision()` made to allow TF32, so cuDNN may take the TF32
    tensor cores for its f32 convolutions, as it does by default."""
    import torch

    from vit_ae_plus_plus_torch.models import resnet3d as tr
    from vit_ae_plus_plus_torch.pipelines import resnet_kfold as trk

    cudnn = torch.backends.cudnn
    real = tr.conv_precision

    def allow_tf32():
        return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                           allow_tf32=True)

    tr.conv_precision = trk.conv_precision = allow_tf32
    try:
        yield
    finally:
        tr.conv_precision = trk.conv_precision = real


class ResNetStep:
    """The full-width ResNet-10 (widths 64-512) through the port's public
    API on `device` in `dtype`, from a state dict: `generate_model`,
    `create_train_state` with `make_resnet_tx`, `make_resnet_steps` (class
    weights 3, 1 unless given). `bn_in_bf16` rounds every BatchNorm's
    output to its input's dtype (a control: the port keeps it f32)."""

    def __init__(self, sd, device: str, dtype: str, class_weights=(3.0, 1.0), bn_in_bf16: bool = False):
        import torch

        from vit_ae_plus_plus_torch.models.resnet3d import generate_model
        from vit_ae_plus_plus_torch.models.vit import FlaxBatchNorm
        from vit_ae_plus_plus_torch.pipelines.resnet_kfold import make_resnet_steps, make_resnet_tx
        from vit_ae_plus_plus_torch.train import create_train_state

        self.model = generate_model(RESNET_DEPTH, n_classes=2, dtype=dtype)
        self.model.load_state_dict(sd, strict=True)
        self.model.to(device, torch.float64 if dtype == "float64" else torch.float32)
        if bn_in_bf16:
            for m in self.model.modules():
                if isinstance(m, FlaxBatchNorm):
                    m.forward = (lambda f: lambda h: f(h).to(h.dtype))(m.forward)
        self.device = device
        # warmup over 5 epochs of 1 step: update k at lr 1e-4 * k / 5
        self.state = create_train_state(self.model, make_resnet_tx(1e-4, 10, 1))
        self.train_step, self.eval_step = make_resnet_steps(self.model, class_weights)

    def run(self, batch, labels) -> tuple:
        """One step. -> (loss, every gradient, every BatchNorm buffer after
        it), on the host in f32."""
        self.state, metrics = self.train_step(self.state, batch.to(self.device), labels)
        grads = {n: p.grad.detach().float().cpu() for n, p in self.model.named_parameters()}
        bufs = {n: b.detach().float().cpu() for n, b in self.model.named_buffers()}
        return float(metrics["loss"]), grads, bufs


@contextlib.contextmanager
def plain_convolutions():
    """The port's ResNet with every convolution `conv_plain`: f32
    convolutions (TF32 off) over operands rounded to the compute dtype,
    outputs rounded to it. Under bf16 the same rounding points as cuDNN's
    bf16 convolutions, the f32 sums in another order."""
    from vit_ae_plus_plus_torch.models import resnet3d as tr

    real = tr._conv
    tr._conv = lambda x, conv, dtype: tr.conv_plain(x, conv.weight, conv.stride, conv.padding, dtype)
    try:
        yield
    finally:
        tr._conv = real


def resnet_errs(got: tuple, want: tuple) -> dict:
    """The loss over its magnitude; each gradient's and each BatchNorm
    buffer's largest error over its largest magnitude: the worst gradient,
    the median gradient and the worst buffer."""
    def each(g: dict, w: dict) -> list:
        return [float((g[n] - w[n]).abs().max() / w[n].abs().max().clamp_min(1e-30)) for n in w]

    grads = each(got[1], want[1])
    return {"loss": abs(got[0] - want[0]) / abs(want[0]), "grads": max(grads),
            "grads_median": float(np.median(grads)), "buffers": max(each(got[2], want[2]))}


def resnet_step_phase() -> None:
    """Phase 5f (a): ResNet-10 at full width (widths 64-512) on 96^3
    volumes. Gates, from one seeded init and one seeded batch of
    RESNET_GATE_BATCH with both classes: the f32 step on the card (cuDNN's
    convolutions, with PyTorch's process-wide `cudnn.allow_tf32` left at
    its default True, so that only the model's `conv_precision()` keeps
    TF32 off) against the same step on the CPU, within RESNET_TOL["float32"]
    on the loss, every gradient and every BatchNorm buffer; the same card
    step with TF32 allowed (`tf32_convolutions`) must miss that gate; the
    bf16 step on the card against the same step with `plain_convolutions`
    within RESNET_TOL["bfloat16"], which the f32 step and the step with
    class weights (1, 1) must miss. As information: the CPU's f64 step (how
    far f32 itself is from exact), the bf16 step against the f32 one, and
    BatchNorm's output rounded to bf16 against the plain step. Then, at the CLI's batch of 8, as information
    beside the card: ms per step and volumes/s in bf16 and f32 (CUDA
    events), evaluation ms per slab, peak memory, and a torch.profiler
    breakdown of one bf16 step with its device-idle share."""
    import torch

    from vit_ae_plus_plus_torch.models.resnet3d import generate_model

    t0 = time.perf_counter()
    card = card_line()
    model = generate_model(RESNET_DEPTH, n_classes=2)
    model.init_weights(torch.Generator().manual_seed(71))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    rng = np.random.default_rng(73)
    batch = torch.from_numpy(rng.standard_normal((RESNET_GATE_BATCH, 1, VOLUME, VOLUME, VOLUME), dtype=np.float32))
    labels = np.arange(RESNET_GATE_BATCH) % 2
    t = time.perf_counter()
    cpu = ResNetStep(sd, "cpu", "float32").run(batch, labels)
    cpu_s = time.perf_counter() - t
    cpu64 = ResNetStep(sd, "cpu", "float64").run(batch, labels)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default: the model has to keep TF32 off itself
    try:
        f32 = ResNetStep(sd, "cuda", "float32").run(batch, labels)
        with tf32_convolutions():
            tf32 = ResNetStep(sd, "cuda", "float32").run(batch, labels)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    bf16 = ResNetStep(sd, "cuda", "bfloat16").run(batch, labels)
    # the bf16 gate's reference: the same step with plain convolutions; the
    # floor: that step on the input scaled by 1 + 2^-20, how far a change in
    # the last bits carries through bf16 roundings and train-mode BatchNorm
    with plain_convolutions():
        plain = ResNetStep(sd, "cuda", "bfloat16").run(batch, labels)
        floor = ResNetStep(sd, "cuda", "bfloat16").run(batch * (1 + 2**-20), labels)
        bn_bf16 = ResNetStep(sd, "cuda", "bfloat16", bn_in_bf16=True).run(batch, labels)
        cw11 = ResNetStep(sd, "cuda", "bfloat16", class_weights=(1.0, 1.0)).run(batch, labels)

    def within(errs: dict, tol: dict) -> bool:
        return all(errs[k] <= tol[k] for k in tol)

    def line(errs: dict) -> str:
        return ", ".join(f"{k} {e:.3g}" for k, e in errs.items())

    print(f"resnet step, information: the CPU's f32 step vs its f64 step {line(resnet_errs(cpu, cpu64))}; "
          f"the card's f32 step vs the CPU's f64 {line(resnet_errs(f32, cpu64))}; the bf16 step vs the f32 "
          f"step {line(resnet_errs(bf16, f32))}; BatchNorm's output rounded to bf16 (plain convolutions) vs "
          f"the plain step {line(resnet_errs(bn_bf16, plain))}", flush=True)
    errs = {"f32 card vs CPU": (resnet_errs(f32, cpu), "float32"),
            "f32 card with TF32 allowed vs CPU (control)": (resnet_errs(tf32, cpu), "float32"),
            "bf16 card vs plain convolutions": (resnet_errs(bf16, plain), "bfloat16"),
            "plain convolutions on the nudged input (floor)": (resnet_errs(floor, plain), "bfloat16"),
            "f32 card vs plain convolutions (control)": (resnet_errs(f32, plain), "bfloat16"),
            "class weights (1, 1) vs plain convolutions (control)": (resnet_errs(cw11, plain), "bfloat16")}
    for what, (e, dtype) in errs.items():
        print(f"resnet step {what}: {line(e)} (gate {line(RESNET_TOL[dtype])})", flush=True)
    check(np.isfinite(cpu[0]) and np.isfinite(f32[0]) and np.isfinite(bf16[0]), "resnet step losses finite")
    check(within(errs["f32 card vs CPU"][0], RESNET_TOL["float32"]), "resnet f32 step on the card vs the CPU")
    check(not within(errs["f32 card with TF32 allowed vs CPU (control)"][0], RESNET_TOL["float32"]),
          "the f32 gate did not see TF32 convolutions")
    check(within(errs["bf16 card vs plain convolutions"][0], RESNET_TOL["bfloat16"]),
          "resnet bf16 step vs its plain convolutions")
    for what in ("f32 card vs plain convolutions (control)", "class weights (1, 1) vs plain convolutions (control)"):
        check(not within(errs[what][0], RESNET_TOL["bfloat16"]), f"the bf16 gate did not see {what}")
    print(f"resnet step gates ({card}): CPU step of batch {RESNET_GATE_BATCH} {cpu_s:.1f} s "
          f"({torch.get_num_threads()} threads)", flush=True)

    big = torch.from_numpy(rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME), dtype=np.float32)).cuda()
    big_labels = np.arange(BATCH) % 2
    times, peak = {}, {}
    for dtype in ("bfloat16", "float32"):
        base = reset_peak()
        step = ResNetStep(sd, "cuda", dtype)

        def one():
            step.state, _ = step.train_step(step.state, big, big_labels)

        times[dtype] = cuda_ms(one, reps=5)
        peak[dtype] = (torch.cuda.max_memory_allocated() - base) / 2**30
        times[f"eval {dtype}"] = cuda_ms(lambda: step.eval_step(big, big_labels), reps=5)
        if dtype == "bfloat16":
            profile_run(one, f"bf16 ResNet-10 step of batch {BATCH}", times[dtype])
        del step
    reset_peak()
    print(f"resnet-10 steps ({card}, CUDA events, batch {BATCH}, 96^3): bf16 {times['bfloat16']:.2f} ms "
          f"({BATCH / times['bfloat16'] * 1e3:.1f} volumes/s), f32 {times['float32']:.2f} ms "
          f"({BATCH / times['float32'] * 1e3:.1f} volumes/s); evaluation per slab bf16 "
          f"{times['eval bfloat16']:.2f} ms, f32 {times['eval float32']:.2f} ms; peak memory above the start "
          f"bf16 {peak['bfloat16']:.2f} GiB, f32 {peak['float32']:.2f} GiB", flush=True)
    print(f"resnet step phase {time.perf_counter() - t0:.1f}s", flush=True)


def resnet_kfold_phase(split_dir: Path) -> None:
    """Phase 5f (b): the port's `resnet-kfold` command on phase 5c's split
    (48 volumes of 96^3), 2 folds of 24 training and 24 test volumes, 2
    epochs of 3 steps at batch 8, in its default bf16 and in f32, counts
    read around it. Checks: exit 0, no custom kernel launched (the ResNet
    runs cuDNN's convolutions), 4 finite `log.txt` rows, each fold's best
    `.pth` loads into `ResNet3D` and its best ROC is the best of its rows;
    then `--eval-only` on the same work dir reads each fold's best ROC back
    bitwise (the same weights, inputs and padding through cuDNN's
    deterministic forward). Prints, beside the card, the command's wall
    time split into training epochs, evaluation, best-model writes and the
    rest, and the eval-only run's."""
    import torch

    from vit_ae_plus_plus_torch.models.resnet3d import generate_model
    from vit_ae_plus_plus_torch.pipelines import resnet_kfold as trk

    t0 = time.perf_counter()
    card = card_line()
    folds, epochs = 2, 2
    spans = [(trk, "train_epoch", "training epochs"), (trk, "evaluate", "evaluation"),
             (trk, "save_state_dict", "best-model writes")]
    for dtype in ("bfloat16", "float32"):
        work = split_dir.parent / f"resnet_{dtype}"
        argv = ["resnet-kfold", "--data-path", str(split_dir), "--work-dir", str(work), "--volume-size",
                str(VOLUME), "--batch-size", str(BATCH), "--epochs", str(epochs), "--n-splits", str(folds)]
        if dtype == "float32":
            argv += ["--compute-dtype", "float32"]
        with Spans(spans) as timed:
            last, wall, counts = run_cli(argv, f"resnet-kfold {dtype}")
        check(totals(counts) == NO_LAUNCHES, f"resnet-kfold {dtype} launched {totals(counts)}")
        results = json.loads(last)
        with open(work / "log.txt") as f:
            logged = [json.loads(line) for line in f]
        check([(r["fold"], r["epoch"]) for r in logged] == [(k, e) for k in range(folds) for e in range(epochs)]
              and all(np.isfinite(v) for r in logged for v in r.values()), f"resnet-kfold {dtype} log.txt {logged}")
        for k in range(folds):
            best = max(r["test_roc_auc_score"] for r in logged if r["fold"] == k)
            check(results[str(k)]["best_roc"] == best and 0.0 <= best <= 1.0,
                  f"resnet-kfold {dtype} fold {k}: best_roc {results[str(k)]} vs rows {best}")
            sd = torch.load(work / "checkpoints" / f"best_ft_model_split{k}.pth", map_location="cpu",
                            weights_only=True)
            generate_model(RESNET_DEPTH, n_classes=2).load_state_dict(sd, strict=True)
        train_line = timed.line(wall)
        with Spans(spans) as timed:
            last, eval_wall, counts = run_cli(argv + ["--eval-only"], f"resnet-kfold {dtype} --eval-only")
        check(totals(counts) == NO_LAUNCHES, f"resnet-kfold --eval-only launched {totals(counts)}")
        evaluated = json.loads(last)
        with open(work / "log.txt") as f:
            check(len(f.readlines()) == folds * epochs, "resnet-kfold --eval-only wrote a log row")
        for k in range(folds):
            check(evaluated[str(k)]["roc_auc_score"] == results[str(k)]["best_roc"],
                  f"resnet-kfold {dtype} --eval-only fold {k}: {evaluated[str(k)]} vs {results[str(k)]}")
        print(f"resnet-kfold {dtype} ({card}): {train_line}; {folds * epochs * 3} steps, "
              f"{folds * epochs * 3} evaluation slabs; best ROC by fold "
              + ", ".join(f"{results[str(k)]['best_roc']:.4f}" for k in range(folds))
              + f", read back bitwise by --eval-only ({timed.line(eval_wall)})", flush=True)
        shutil.rmtree(work)
    print(f"resnet-kfold phase {time.perf_counter() - t0:.1f}s", flush=True)


def eval_classical_phase(feature_dir: Path) -> None:
    """Phase 5f (c): the port's `eval-classical` on phase 5d's bf16
    per-fold features (24 training rows, 12 of each label, and 24 test rows
    of 768 features a fold), `--n-splits 2`, twice. Checks: exit 0, the
    summary's keys, each fold's AUC finite in [0, 1], the second run's
    summary equal to the first. Prints the libsvm build time (g++ on the
    card's host) and each run's wall time."""
    from vit_ae_plus_plus_torch.utils import libsvm

    card = card_line()
    t = time.perf_counter()
    libsvm.load()
    build_s = time.perf_counter() - t
    argv = ["eval-classical", "--feature-dir", str(feature_dir), "--n-splits", "2"]
    first, wall1, _ = run_cli(argv, "eval-classical")
    second, wall2, _ = run_cli(argv, "eval-classical (again)")
    summary = json.loads(first)
    check(sorted(summary) == ["auroc_mean", "auroc_std", "per_fold", "sensitivity_mean", "specificity_mean"]
          and sorted(summary["per_fold"]) == ["auroc", "sensitivity", "specificity"]
          and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in summary["per_fold"]["auroc"])
          and len(summary["per_fold"]["auroc"]) == 2, f"eval-classical summary {summary}")
    check(first == second, f"eval-classical twice: {first} vs {second}")
    print(f"eval-classical ({card}, host only): libsvm build {build_s:.2f} s; wall {wall1:.2f} s and "
          f"{wall2:.2f} s for 2 folds of 41 SVM fits each (8 candidates x 5 splits + the refit); AUC by fold "
          + ", ".join(f"{a:.4f}" for a in summary["per_fold"]["auroc"]) + "; equal on the second run", flush=True)


# phase 5f (c), --method linear: lbfgs and newton-cg, both l2 at
# max_iter=1000, converge to one optimum only within their tolerances
# (gtol / max|gradient| <= 1e-4), so their probabilities agree to a limit,
# not bitwise (parity with scikit-learn is held in the CPU tests, as the
# card's machine has no scikit-learn). How far apart they land, and how far
# lbfgs stopped at max_iter=1 (the control) lands, depends on the features.
# 5d's are nearly one vector: the rows share a mean of norm about 27.7 (768
# LayerNorm'd features) and spread about 0.04 a feature around it (the
# phase prints both). On the CPU, over 12 seeded stand-ins of that make
# (a standard normal mean, spread 0.04, the classes 0 or 0.01 apart; 24
# training and 24 test rows of 768 f32 features), the two solvers'
# predict_proba differ by at most 2.12e-3 and the control by at least
# 3.68e-2 (tests/test_torch_port_linear.py test_linear_gate_margins, which
# holds LINEAR_GATE 3x above the first and 3x below the second).
LINEAR_GATE = 0.01


def eval_classical_linear_phase(feature_dir: Path) -> None:
    """Phase 5f (c), the logistic regression: the port's copies of
    scikit-learn's liblinear and of its SAG solver and half binomial loss,
    built with g++ on the card's host (the build times printed); then
    `eval-classical --method linear --n-splits 2` on 5d's bf16 features,
    twice: exit 0, the summary's keys, each fold's AUC finite in [0, 1],
    the second summary equal to the first; each fold's search refitted here
    gives the summary's AUC and its `best_params_` (printed). The gate: on
    fold 0, lbfgs and newton-cg (l2, max_iter=1000) both converge and their
    `predict_proba` on the test rows agree within LINEAR_GATE, which lbfgs
    at max_iter=1 must miss. Prints the wall times, the card's scipy and
    numpy versions and the card's line."""
    import scipy

    from vit_ae_plus_plus_torch.pipelines import classical_models as cm
    from vit_ae_plus_plus_torch.pipelines.eval_classical import evaluate_results
    from vit_ae_plus_plus_torch.pipelines.logistic import LogisticRegression
    from vit_ae_plus_plus_torch.utils import liblinear, sag
    from vit_ae_plus_plus_torch.utils.optimize import ConvergenceWarning

    card = card_line()
    t_phase = t = time.perf_counter()
    liblinear.load()
    liblinear_s = time.perf_counter() - t
    t = time.perf_counter()
    sag.load()
    sag_s = time.perf_counter() - t
    argv = ["eval-classical", "--feature-dir", str(feature_dir), "--n-splits", "2", "--method", "linear"]
    first, wall1, _ = run_cli(argv, "eval-classical --method linear")
    second, wall2, _ = run_cli(argv, "eval-classical --method linear (again)")
    summary = json.loads(first)
    check(sorted(summary) == ["auroc_mean", "auroc_std", "per_fold", "sensitivity_mean", "specificity_mean"]
          and sorted(summary["per_fold"]) == ["auroc", "sensitivity", "specificity"]
          and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in summary["per_fold"]["auroc"])
          and len(summary["per_fold"]["auroc"]) == 2, f"eval-classical --method linear summary {summary}")
    check(first == second, f"eval-classical --method linear twice: {first} vs {second}")

    def fold(k):
        return [np.load(feature_dir / f"{split}_contrast_ssl_{what}_split_{k}.npy")
                for split in ("train", "test") for what in ("features", "labels")]

    best = []
    t = time.perf_counter()
    for k in range(2):
        X, y, X_test, y_test = fold(k)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ConvergenceWarning)
            search = cm.RandomizedSearchCV(cm._estimator("linear"), cm.PARAM_GRIDS["linear"],
                                           random_state=42).fit(X, y)
        auc = evaluate_results(search.predict_proba(X_test)[:, 1], y_test)[2]
        check(auc == summary["per_fold"]["auroc"][k], f"fold {k}: the search's AUC {auc} vs the command's "
              f"{summary['per_fold']['auroc'][k]}")
        best.append(search.best_params_)
    search_s = time.perf_counter() - t

    X, y, X_test, _ = fold(0)
    probs, iters = {}, {}
    for solver, max_iter in (("lbfgs", 1000), ("newton-cg", 1000), ("lbfgs", 1)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", ConvergenceWarning)
            est = LogisticRegression(random_state=42, solver=solver, max_iter=max_iter).fit(X, y)
        converged = not any(issubclass(w.category, ConvergenceWarning) for w in caught)
        probs[solver, max_iter], iters[solver, max_iter] = est.predict_proba(X_test), int(est.n_iter_[0])
        check(np.isfinite(probs[solver, max_iter]).all(), f"{solver} max_iter={max_iter}: probabilities")
        if max_iter == 1000:
            check(converged and iters[solver, max_iter] < max_iter,
                  f"{solver} (l2, max_iter=1000) on fold 0 did not converge ({iters[solver, max_iter]} iterations)")
    gate = float(np.abs(probs["lbfgs", 1000] - probs["newton-cg", 1000]).max())
    control = float(np.abs(probs["lbfgs", 1] - probs["newton-cg", 1000]).max())
    print(f"linear gate on fold 0 ({X.shape[0]} x {X.shape[1]} {X.dtype}; the rows' mean of norm "
          f"{np.linalg.norm(X.mean(axis=0)):.2f}, spread {X.std(axis=0).mean():.4f} a feature around it): lbfgs "
          f"({iters['lbfgs', 1000]} iterations) vs newton-cg ({iters['newton-cg', 1000]}) max|predict_proba diff| "
          f"{gate:.3e} (limit {LINEAR_GATE}); control lbfgs at max_iter=1 {control:.3e}", flush=True)
    check(gate <= LINEAR_GATE, f"lbfgs vs newton-cg on fold 0: {gate:.3e} > {LINEAR_GATE}")
    check(control > LINEAR_GATE, f"the control (lbfgs at max_iter=1) met the linear gate: {control:.3e}")
    print(f"eval-classical --method linear ({card}, host only; scipy {scipy.__version__}, numpy {np.__version__}): "
          f"liblinear build {liblinear_s:.2f} s, sag and loss build {sag_s:.2f} s; wall {wall1:.2f} s and "
          f"{wall2:.2f} s for 2 folds of 51 fits each (10 candidates x 5 splits + the refit); the searches again "
          f"{search_s:.2f} s; AUC by fold " + ", ".join(f"{a:.4f}" for a in summary["per_fold"]["auroc"])
          + "; best_params_ by fold " + "; ".join(
              f"{p['solver']}/{p['penalty']}/{p['max_iter']}" for p in best)
          + f"; equal on the second run; the linear part of 5f (c) {time.perf_counter() - t_phase:.2f} s", flush=True)


# phase 5f (c), --method rf: the card's machine has no scikit-learn, so
# the port's copy of its tree builder is held to scikit-learn 1.9.0's
# numbers taken on the CPU (tests/test_torch_port_forest.py
# test_rf_reference_is_sklearns holds these constants to scikit-learn's
# live output): a stand-in of 5d's features (rows that share a standard
# normal mean and spread 0.04 a feature around it, the classes 0.01 apart,
# rounded through bfloat16 as 5d's bf16 features are, so that about 18 of
# the 24 values of a feature are distinct and ties are common), 24
# training and 24 test rows of 768 features from numpy's RandomState(0);
# at two points of the rf grid that cover both criteria and both
# class-weight modes, the forest's `predict_proba` on the test rows (class
# 1) and a sha256 over every tree's arrays (RF_TREE_ARRAYS, in tree
# order). This checks the card's g++, libm and numpy against the wheel's;
# the same fits at random_state=43, the control, must miss both.
RF_PROBLEM = {"seed": 0, "width": 768, "n_rows": 24, "spread": 0.04, "apart": 0.01}
RF_TREE_ARRAYS = ("children_left", "children_right", "feature", "threshold", "impurity", "n_node_samples",
                  "weighted_n_node_samples", "missing_go_to_left", "value")
RF_REFERENCE = (
    {"params": {"n_estimators": 50, "criterion": "gini", "class_weight": "balanced"},
     "proba1": (0.4, 0.58, 0.48, 0.48, 0.34, 0.5, 0.44, 0.46, 0.52, 0.6, 0.42, 0.58, 0.42, 0.54, 0.54, 0.48,
                0.44, 0.34, 0.54, 0.58, 0.46, 0.48, 0.42, 0.42),
     "trees_sha256": "3d30cd400deb9d54e4aeb4ddc8b71a0427d32f72d64f63afe0dc914a1826e2b4"},
    {"params": {"n_estimators": 100, "criterion": "entropy", "class_weight": "balanced_subsample"},
     "proba1": (0.42, 0.6, 0.43, 0.6, 0.4, 0.59, 0.36, 0.48, 0.46, 0.56, 0.52, 0.52, 0.37, 0.47, 0.59, 0.53,
                0.53, 0.47, 0.49, 0.58, 0.45, 0.47, 0.42, 0.58),
     "trees_sha256": "3372f87986fcffb7095976720bee7db932d29e400397540df3e3ace6629529e6"},
)


def bf16_round(a) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even) and
    back, in numpy."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def rf_reference_problem() -> tuple:
    """RF_PROBLEM's (X, y, X_test): float32 rows, int labels."""
    rs = np.random.RandomState(RF_PROBLEM["seed"])
    width, n, spread, apart = (RF_PROBLEM[k] for k in ("width", "n_rows", "spread", "apart"))
    mean = rs.standard_normal(width)
    y = rs.permutation(np.arange(n) % 2)
    X = bf16_round(mean + spread * rs.standard_normal((n, width)) + apart * y[:, None])
    X_test = bf16_round(mean + spread * rs.standard_normal((n, width)) + apart * (np.arange(n) % 2)[:, None])
    return X, y, X_test


def forest_digest(trees) -> str:
    """sha256 over RF_TREE_ARRAYS of each tree (objects with those
    attributes: scikit-learn's `tree_` or the port's `Tree`), in order."""
    h = hashlib.sha256()
    for tree in trees:
        for name in RF_TREE_ARRAYS:
            h.update(np.ascontiguousarray(getattr(tree, name)).tobytes())
    return h.hexdigest()


def eval_classical_rf_phase(feature_dir: Path) -> None:
    """Phase 5f (c), the random forest: the port's copy of scikit-learn's
    tree builder, built with g++ on the card's host (the build time
    printed); the gate, RF_REFERENCE met bit for bit and missed by its
    control; then `eval-classical --method rf --n-splits 2` on 5d's bf16
    features, twice: exit 0, the summary's keys, each fold's AUC finite in
    [0, 1], the second summary equal to the first; each fold's search
    refitted here gives the summary's AUC. Prints the wall times, the trees
    grown a fold, the microseconds a tree, each fold's `best_params_`, the
    card's numpy version and the card's line."""
    from vit_ae_plus_plus_torch.pipelines import classical_models as cm
    from vit_ae_plus_plus_torch.pipelines.eval_classical import evaluate_results
    from vit_ae_plus_plus_torch.pipelines.forest import RandomForestClassifier
    from vit_ae_plus_plus_torch.utils import tree

    card = card_line()
    t_phase = t = time.perf_counter()
    tree.load()
    build_s = time.perf_counter() - t

    X, y, X_test = rf_reference_problem()
    for ref in RF_REFERENCE:
        forest = RandomForestClassifier(random_state=42, **ref["params"]).fit(X, y)
        proba1, digest = forest.predict_proba(X_test)[:, 1], forest_digest(e.tree_ for e in forest.estimators_)
        control = RandomForestClassifier(random_state=43, **ref["params"]).fit(X, y)
        c_proba1, c_digest = control.predict_proba(X_test)[:, 1], forest_digest(e.tree_ for e in control.estimators_)
        point = "/".join(str(v) for v in ref["params"].values())
        print(f"rf gate at {point}: trees sha256 {digest[:16]} (reference {ref['trees_sha256'][:16]}), "
              f"predict_proba {'equal' if np.array_equal(proba1, ref['proba1']) else 'NOT equal'}; control "
              f"random_state=43 {c_digest[:16]}", flush=True)
        check(digest == ref["trees_sha256"] and np.array_equal(proba1, np.asarray(ref["proba1"])),
              f"rf at {point}: the port's forest differs from scikit-learn 1.9.0's ({digest}; {proba1.tolist()})")
        check(c_digest != ref["trees_sha256"] and not np.array_equal(c_proba1, np.asarray(ref["proba1"])),
              f"rf at {point}: the control (random_state=43) met the reference")

    argv = ["eval-classical", "--feature-dir", str(feature_dir), "--n-splits", "2", "--method", "rf"]
    first, wall1, _ = run_cli(argv, "eval-classical --method rf")
    second, wall2, _ = run_cli(argv, "eval-classical --method rf (again)")
    summary = json.loads(first)
    check(sorted(summary) == ["auroc_mean", "auroc_std", "per_fold", "sensitivity_mean", "specificity_mean"]
          and sorted(summary["per_fold"]) == ["auroc", "sensitivity", "specificity"]
          and all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in summary["per_fold"]["auroc"])
          and len(summary["per_fold"]["auroc"]) == 2, f"eval-classical --method rf summary {summary}")
    check(first == second, f"eval-classical --method rf twice: {first} vs {second}")

    best, trees, search_s = [], [], []
    for k in range(2):
        X, y, X_test, y_test = (np.load(feature_dir / f"{split}_contrast_ssl_{what}_split_{k}.npy")
                                for split in ("train", "test") for what in ("features", "labels"))
        t = time.perf_counter()
        search = cm.RandomizedSearchCV(cm._estimator("rf"), cm.PARAM_GRIDS["rf"], random_state=42).fit(X, y)
        search_s.append(time.perf_counter() - t)
        auc = evaluate_results(search.predict_proba(X_test)[:, 1], y_test)[2]
        check(auc == summary["per_fold"]["auroc"][k], f"fold {k}: the rf search's AUC {auc} vs the command's "
              f"{summary['per_fold']['auroc'][k]}")
        best.append(search.best_params_)
        trees.append(cm.CV * sum(p["n_estimators"] for p in search.cv_results_["params"])
                     + search.best_params_["n_estimators"])
    print(f"eval-classical --method rf ({card}, host only; numpy {np.__version__}): tree build {build_s:.2f} s; "
          f"wall {wall1:.2f} s and {wall2:.2f} s for 2 folds of 51 forests each (10 candidates x 5 splits + the "
          f"refit); trees grown by fold {trees[0]}, {trees[1]}; the searches again {search_s[0]:.2f} s and "
          f"{search_s[1]:.2f} s, {1e6 * sum(search_s) / sum(trees):.1f} us a tree; AUC by fold "
          + ", ".join(f"{a:.4f}" for a in summary["per_fold"]["auroc"]) + "; best_params_ by fold " + "; ".join(
              f"{p['n_estimators']}/{p['criterion']}/{p['class_weight']}" for p in best)
          + f"; equal on the second run; the rf part of 5f (c) {time.perf_counter() - t_phase:.2f} s", flush=True)


# phase 5g: the MoCo-v3 baseline. Its step's kernel-against-plain gate runs
# at batch 8 (the command's batch; a plain step holds 40 GB in bf16, 45 GB
# in f32) from the state `moco-kfold` starts in: the momentum encoder a copy
# of the base. The symmetric InfoNCE after BatchNorms over the batch makes
# the step ill-conditioned at a random init: on an H100 the plain step moves
# its f32 gradients by 2.3e-5 to 6.4e-5 on its own views scaled by 1 +- 2^-20
# (the kernels read 2.6e-5 to 4.8e-5), above STEP_TOL's 1e-5, and in bf16
# rounding noise alone moves every gradient by 0.37-0.42 of its norm and the
# loss by up to 1.2e-3 (the bf16 plain step against the f32 one, the nudged
# plain step: `moco_step_conditioning.py`, both momentum encoders). So in
# f32 the gradients are held to STEP_TOL or MOCO_FLOOR_FACTOR times that
# floor, whichever is larger (about 1e-4 to 2.5e-4), and the plain step
# with TF32 products (0.058-0.31 there) must miss that limit; the loss, the
# momentum leaves and the running statistics to STEP_TOL itself. The bf16
# step's readings are information only: phase 2 holds the bf16 kernels at
# this shape (B8 H12 N1729 d64, forward and backward) and phase 5e the bf16
# fine-tune step through them within STEP_TOL.
MOCO_M, MOCO_FLOOR_FACTOR = 0.99, 4
MOCO_GRADS = ("base_encoder.blocks.0.attn.qkv.weight", "base_encoder.patch_embed.proj.weight",
              "base_encoder.head.0.weight")
MOCO_STATS = ("base_encoder.head.1.running_mean", "base_encoder.head.1.running_var",
              "base_encoder.head.7.running_var", "predictor.1.running_var")
# by trunk: the gradients, the running statistics and the momentum
# encoder's leaves (a parameter after the EMA, a statistic after the last
# EMA) that a MoCo step's readings hold
MOCO_NAMES = {
    "vit": (MOCO_GRADS, MOCO_STATS, ("blocks.0.attn.qkv.weight", "head.1.running_mean")),
    "resnet": (("base_encoder.conv1.weight", "base_encoder.layer4.0.conv2.weight", "base_encoder.fc.0.weight"),
               ("base_encoder.bn1.running_mean", "base_encoder.layer4.0.bn2.running_var",
                "base_encoder.fc.4.running_var", "predictor.1.running_var"),
               ("conv1.weight", "fc.1.running_mean")),
}


def moco_tree(seed: int):
    """Seeded numpy weights in the JAX package's MoCo-ViT tree (`trunk`:
    ViT-B at 96^3 / patch 8 with its learned pos_embed and `norm`;
    `projector` 768-4096-4096-256 and `predictor` 256-4096-256, each with
    its last BatchNorm) and its flax `batch_stats`."""
    from vit_ae_plus_plus_torch.configs import ViTConfig

    cfg = ViTConfig(volume_size=VOLUME, patch_size=PATCH)
    rng = np.random.default_rng(seed + 1)
    trunk = mae_encoder_tree(cfg, seed)
    trunk["pos_embed"] = (0.02 * rng.standard_normal((1, cfg.num_patches + 1, cfg.embed_dim))).astype(np.float32)
    tree, stats = {"trunk": trunk}, {}
    for name, dims in (("projector", (cfg.embed_dim, 4096, 4096, 256)), ("predictor", (256, 4096, 256))):
        layers, bn = {}, {}
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            layers[f"Dense_{i}"] = dense(rng, a, b, bias=False)
            if i < len(dims) - 2:
                layers[f"BatchNorm_{i}"] = ln(rng, b)
            bn[f"BatchNorm_{i}"] = {"mean": (0.1 * rng.standard_normal(b)).astype(np.float32),
                                    "var": (1 + 0.1 * rng.random(b)).astype(np.float32)}
        tree[name], stats[name] = layers, bn
    return tree, stats


@functools.lru_cache(maxsize=None)
def moco_base_sd(arch: str) -> dict:
    """The base model's state dict of the MoCo step checks, on the host, made
    once a process: the ViT's from `moco_tree(81)` through `params_from_jax`,
    the ResNet-10's (widths 64-512) from the port's `init_weights` at seed
    84. Every process makes the same."""
    import torch

    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.pipelines.moco_kfold import build_moco_model
    from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

    if arch == "vit":
        tree, stats = moco_tree(81)
        return params_from_jax(tree, PATCH, 1, stats)
    model = build_moco_model(DataConfig(volume_size=VOLUME), "float32", "resnet")
    return model.init_weights(torch.Generator().manual_seed(84)).state_dict()


def moco_views(device="cuda") -> list:
    """The two seeded views of phase 5g's MoCo step (B8, 96^3), f32."""
    import torch

    rng = np.random.default_rng(83)
    return [torch.from_numpy(rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME), dtype=np.float32)).to(device)
            for _ in range(2)]


class MoCoTrainer:
    """One MoCo training run of the port's public API on the card:
    `build_moco_model` (ViT-B at 96^3 / patch 8 or ResNet-10, heads 4096 /
    256), the base model's state dict and its momentum encoder's
    (`momentum_sd`, or a copy of the base as `moco-kfold` starts it),
    `create_moco_state` with `make_lars` (lr 0.6 x 8 / 256, no warmup: the
    warmup's first learning rate is 0), `make_moco_train_step`."""

    def __init__(self, base_sd, dtype: str, attn_impl: str, momentum_sd=None, arch: str = "vit"):
        from vit_ae_plus_plus_torch.configs import DataConfig
        from vit_ae_plus_plus_torch.pipelines.moco_kfold import (
            build_moco_model, create_moco_state, make_moco_train_step,
        )
        from vit_ae_plus_plus_torch.train import warmup_cosine_schedule
        from vit_ae_plus_plus_torch.train.optim import make_lars

        self.label, self.arch = f"{arch} {dtype} {attn_impl}", arch
        self.model = build_moco_model(DataConfig(volume_size=VOLUME), dtype, arch,
                                      vit_overrides={"attn_impl": attn_impl})
        self.model.load_state_dict(base_sd, strict=True)
        self.model.cuda()
        schedule = warmup_cosine_schedule(0.6 * BATCH / 256, 0.0, 0, 100, 3)
        self.state = create_moco_state(self.model, make_lars(schedule, weight_decay=1e-6))
        if momentum_sd is not None:
            prefix = "base_encoder."
            self.state.momentum_encoder.load_state_dict(
                {k[len(prefix):]: v for k, v in momentum_sd.items() if k.startswith(prefix)}, strict=True)
        self.step = make_moco_train_step(self.model)

    def run(self, x1, x2) -> tuple:
        """One step, counts set to 0 before and read after. -> ({loss and the
        trunk's MOCO_NAMES: gradients, statistics, momentum leaves} on the
        card in f32, launch counts by (wrapper, shape))."""
        from vit_ae_plus_plus_torch.kernels import reset_launch_counts

        reset_launch_counts()
        self.state, metrics = self.step(self.state, x1, x2, MOCO_M)
        out = {"loss": float(metrics["loss"])}
        counts = shape_counts()
        named, bufs = dict(self.model.named_parameters()), dict(self.model.named_buffers())
        mom = self.state.momentum_encoder
        grads, stats, mom_leaves = MOCO_NAMES[self.arch]
        out.update({n: named[n].grad.float().clone() for n in grads})
        out.update({n: bufs[n].float().clone() for n in stats})
        mom_named = {**dict(mom.named_parameters()), **dict(mom.named_buffers())}
        out.update({f"momentum_encoder.{n}": mom_named[n].float().clone() for n in mom_leaves})
        check(np.isfinite(out["loss"]) and all(bool(p.grad.isfinite().all()) for p in self.model.parameters()),
              f"MoCo {self.label} step: non-finite loss or gradients")
        return out, counts


def moco_step_launches(dtype: str, batch: int) -> dict:
    """One MoCo step's attention launches: four trunk passes of 12 blocks
    forward (base and momentum encoder on both views), two backward."""
    key = (batch, 12, (VOLUME // PATCH) ** 3 + 1, 64, dtype)
    return {("packed_flash_fwd", key): 48, ("packed_flash_bwd", key): 24}


def moco_errs(got: dict, want: dict) -> dict:
    """The loss over its magnitude; every tensor's largest error over its
    largest magnitude."""
    errs = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"])}
    for n in want:
        if n != "loss":
            errs[n] = float((got[n] - want[n]).abs().max() / want[n].abs().max().clamp_min(1e-30))
    return errs


def on_host(readings: dict) -> dict:
    """A step's readings with its tensors copied to the host (for the
    ranks of phase 7)."""
    return {k: v if isinstance(v, float) else v.cpu() for k, v in readings.items()}


def moco_step_phase(rows: list) -> dict:
    """Phase 5g (a): the full-width MoCo-ViT step (ViT-B at 96^3 / patch 8,
    B8 H12 N1729 d64, every token: nothing is masked) from seeded numpy
    weights and batch statistics through `params_from_jax`, the momentum
    encoder a copy of the base, on seeded views: one step with
    attn_impl="auto" (the packed kernels) against one with "plain" from the
    same state and views. In f32 (see MOCO_FLOOR_FACTOR) the loss, the
    momentum encoder's qkv after the EMA, its projector's running mean after
    the last EMA and MOCO_STATS within STEP_TOL; MOCO_GRADS within STEP_TOL
    or MOCO_FLOOR_FACTOR times the floor, which the plain step with TF32
    products must miss. In bf16 the same readings, as information. The
    launches around each step (48 packed forward and 24 packed backward at
    B8 H12 N1729 d64, into the kernel rows' `moco_launches`). Then, as
    information beside the card: ms per step and volumes/s (CUDA events),
    peak memory and a torch.profiler breakdown of a step with the device's
    idle share. Last, the MoCo-ResNet-10's f32 reference (`moco_resnet_step`).
    -> the one-process steps that phase 7d(e) holds its ranks to: by trunk
    and dtype the kernel step's readings on the host (`want`), and in f32
    the limits."""
    import torch

    t0 = time.perf_counter()
    card = card_line()
    base = moco_base_sd("vit")
    views = moco_views()

    def line(errs: dict) -> str:
        return ", ".join(f"{k} {e:.3g}" for k, e in errs.items())

    def plain_step(dtype: str, scale: float = 1.0, tf32: bool = False) -> dict:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            out, counts = MoCoTrainer(base, dtype, "plain").run(*[v * scale for v in views])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        check(totals(counts) == NO_LAUNCHES, f"plain {dtype} MoCo step launched {totals(counts)}")
        return out

    times, peak, refs = {}, {}, {"vit": {}}
    for dtype in ("bfloat16", "float32"):
        tol = STEP_TOL[dtype]
        want = plain_step(dtype)
        if dtype == "float32":
            floors = [moco_errs(plain_step(dtype, scale), want) for scale in (1 + 2**-20, 1 - 2**-20)]
            tf32 = moco_errs(plain_step(dtype, tf32=True), want)
        base_bytes = reset_peak()
        trainer = MoCoTrainer(base, dtype, "auto")
        got, counts = trainer.run(*views)
        want_counts = moco_step_launches(dtype, BATCH)
        check(counts == want_counts, f"MoCo {dtype} step launched {counts} (want {want_counts})")
        for row in rows:
            n = counts.get((row["name"], row["key"]), 0)
            if n:
                row["moco_launches"], row["moco_path"] = n, f"make_moco_train_step, one {dtype} step of {BATCH}"
        errs = moco_errs(got, want)
        refs["vit"][dtype] = {"want": on_host(got)}
        if dtype == "bfloat16":
            print(f"MoCo step bf16 auto vs plain, information (bf16 rounding moves these as far, see "
                  f"MOCO_FLOOR_FACTOR): {line(errs)}", flush=True)
        else:
            floor = {k: max(f[k] for f in floors) for k in MOCO_GRADS}
            limits = {k: tol["loss"] if k == "loss" else tol["grad"] for k in errs}
            limits.update({k: max(tol["grad"], MOCO_FLOOR_FACTOR * floor[k]) for k in MOCO_GRADS})
            print(f"MoCo step f32 auto vs plain: {line(errs)}; floor (the plain step on the views scaled by "
                  f"1 +- 2^-20): {line(floor)}; limits: {line(limits)}; the plain step with TF32 products "
                  f"(control): {line(tf32)}", flush=True)
            bad = {k: e for k, e in errs.items() if e > limits[k]}
            check(not bad, f"MoCo step f32 auto vs plain: {bad}")
            seen = {k: tf32[k] for k in MOCO_GRADS if tf32[k] <= limits[k]}
            check(not seen, f"the MoCo f32 gradient limits let TF32 products through: {seen}")
            refs["vit"][dtype]["limits"] = limits

        def one():
            trainer.state, _ = trainer.step(trainer.state, *views, MOCO_M)

        times[dtype] = cuda_ms(one, reps=3 if dtype == "bfloat16" else 2, warmup=1)
        peak[dtype] = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
        profile_run(one, f"{dtype} MoCo step of {BATCH}", times[dtype])
        del trainer
        reset_peak()
    print(f"MoCo steps ({card}, CUDA events, batch {BATCH}, ViT-B at 96^3, 4 trunk passes of 1,729 tokens): "
          f"bf16 {times['bfloat16']:.2f} ms ({BATCH / times['bfloat16'] * 1e3:.1f} volumes/s), f32 "
          f"{times['float32']:.2f} ms ({BATCH / times['float32'] * 1e3:.1f} volumes/s); peak memory above the "
          f"weights bf16 {peak['bfloat16']:.2f} GiB, f32 {peak['float32']:.2f} GiB", flush=True)
    refs["resnet"] = {"float32": moco_resnet_step()}
    print(f"MoCo step phase {time.perf_counter() - t0:.1f}s", flush=True)
    return refs


def moco_resnet_step() -> dict:
    """Phase 5g (c): one f32 step of the MoCo-ResNet-10 (widths 64-512, heads
    4096 / 256, `moco_base_sd("resnet")`) at batch 8 on phase 5g's views,
    no custom kernel launched, and the same step on the views scaled by 1
    +- 2^-20: its floor. No kernel of the port runs in it, so nothing holds
    it here; it is the one-process step that phase 7d(e)'s ranks are held
    to, every reading within STEP_TOL or MOCO_FLOOR_FACTOR times its floor
    (cuDNN's f32 convolutions and train-mode BatchNorm carry the summation
    order as far as the nudge does). Prints its ms (CUDA events) and the
    floor beside the card. -> {"want", "limits"}."""
    base, views = moco_base_sd("resnet"), moco_views()

    def step(scale: float = 1.0):
        trainer = MoCoTrainer(base, "float32", "auto", arch="resnet")
        out, counts = trainer.run(*[v * scale for v in views])
        check(totals(counts) == NO_LAUNCHES, f"the MoCo-ResNet step launched {totals(counts)}")
        return trainer, out

    trainer, want = step()

    def one():
        trainer.state, _ = trainer.step(trainer.state, *views, MOCO_M)

    ms = cuda_ms(one, reps=2, warmup=1)
    del trainer
    floors = [moco_errs(step(scale)[1], want) for scale in (1 + 2**-20, 1 - 2**-20)]
    tol = STEP_TOL["float32"]
    floor = {k: max(f[k] for f in floors) for k in floors[0]}
    limits = {k: max(tol["loss"] if k == "loss" else tol["grad"], MOCO_FLOOR_FACTOR * e) for k, e in floor.items()}
    print(f"MoCo-ResNet-10 f32 step of {BATCH} ({card_line()}): {ms:.2f} ms (CUDA events), no custom kernel; "
          f"its floor (the views scaled by 1 +- 2^-20): " + ", ".join(f"{k} {e:.3g}" for k, e in floor.items()),
          flush=True)
    reset_peak()
    return {"want": on_host(want), "limits": limits}


def moco_kfold_phase(split_dir: Path) -> None:
    """Phase 5g (b): the port's `moco-kfold` command on phase 5c's split (48
    volumes of 96^3: 2 folds of 24 training and 24 test volumes), 2 epochs
    of 3 steps at batch 8 with `--ckpt-every 2`, in its default bf16 and in
    f32, counts read around each run. Checks: exit 0; 4 finite `log.txt`
    rows; each fold's min-loss `.pth` loads into `MoCoViT3D`; (24, 768) f32
    features with the labels y_whole at the sorted ids; the attention
    launches by shape (12 steps of 48 forward and 24 backward, 12 slabs of
    12 forward); fold 0's test features against the same `.pth` run with
    attn_impl="plain" within ENGINE_TOL. Then `moco-extract` on the bf16
    work dir, whose files must equal `moco-kfold`'s dumps bitwise, and
    `moco-kfold --moco-arch resnet` in bf16, 2 folds of 1 epoch: exit 0, no
    custom kernel launched, (24, 512) features. Prints each command's wall
    time by span beside the card."""
    import torch

    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.data import Loader, get_dataset
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk
    from vit_ae_plus_plus_torch.pipelines.extract_features import loader_features

    t0 = time.perf_counter()
    card = card_line()
    folds, epochs, fold_vols = 2, 2, DATA_VOLUMES // 2
    steps, slab_count = folds * epochs * (fold_vols // BATCH), folds * 2 * slabs(fold_vols)
    labels = np.load(split_dir / "y_whole_ssl.npy")
    data_cfg = DataConfig(base_path=str(split_dir))
    plain_ds = get_dataset("brats", "whole", data_cfg, transforms=None, use_z_score=True)
    spans = [(tmk, "train_epoch", "training epochs"), (tmk, "extract_moco_features", "extraction"),
             (tmk, "save_state_dict", "min-loss writes"), (tmk, "save_resume", "resume writes")]
    common = ["--data-path", str(split_dir), "--volume-size", str(VOLUME), "--batch-size", str(BATCH),
              "--n-splits", str(folds)]

    def features(work: Path, width: int, what: str) -> dict:
        out = {}
        for k in range(folds):
            for tag in ("train", "test"):
                ids = np.sort(np.load(work / "k_fold" / "indices_file" / f"{tag}_{k}.npy"))
                feats = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_features_split_{k}.npy")
                labs = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_labels_split_{k}.npy")
                check(feats.shape == (fold_vols, width) and feats.dtype == np.float32
                      and bool(np.isfinite(feats).all()), f"{what} fold {k} {tag} features {feats.shape}")
                check(np.array_equal(labs, labels[ids]), f"{what} fold {k} {tag} labels")
                out[(k, tag)] = (ids, feats)
        return out

    key = (BATCH, 12, (VOLUME // PATCH) ** 3 + 1, 64)
    for dtype in ("bfloat16", "float32"):
        work = split_dir.parent / f"moco_{dtype}"
        argv = ["moco-kfold", *common, "--work-dir", str(work), "--epochs", str(epochs), "--ckpt-every", "2"]
        if dtype == "float32":
            argv += ["--compute-dtype", "float32"]
        with Spans(spans) as timed:
            last, wall, counts = run_cli(argv, f"moco-kfold {dtype}")
        results = json.loads(last)
        check(sorted(results) == ["0", "1"] and all(np.isfinite(r["min_loss"]) for r in results.values()),
              f"moco-kfold {dtype} results {results}")
        with open(work / "log.txt") as f:
            logged = [json.loads(line) for line in f]
        check([(r["fold"], r["epoch"]) for r in logged] == [(k, e) for k in range(folds) for e in range(epochs)]
              and all(np.isfinite(r["train_loss"]) for r in logged), f"moco-kfold {dtype} log.txt {logged}")
        want = {("packed_flash_fwd", (*key, dtype)): 48 * steps + 12 * slab_count,
                ("packed_flash_bwd", (*key, dtype)): 24 * steps}
        check(counts == want, f"moco-kfold {dtype} launched {counts} (want {want})")
        feats = features(work, 768, f"moco-kfold {dtype}")
        model = tmk.build_moco_model(DataConfig(volume_size=VOLUME), dtype, vit_overrides={"attn_impl": "plain"})
        for k in (1, 0):  # each fold's .pth loads; fold 0's stays
            model.load_state_dict(torch.load(tmk.min_loss_path(str(work), k), map_location="cpu", weights_only=True),
                                  strict=True)
        ids, got = feats[(0, "test")]
        loader = Loader(plain_ds, BATCH, indices=ids, shuffle=False, drop_last=False)
        ref, _ = loader_features(model.to("cuda").base_encoder, loader, BATCH, torch.device("cuda"))
        err = rel_err(got, ref)
        check(err <= ENGINE_TOL[dtype], f"moco-kfold {dtype} fold 0 test features vs plain: rel err {err:.3g}")
        del model
        print(f"moco-kfold {dtype} ({card}): {timed.line(wall)}; {steps} steps, {slab_count} extraction slabs; "
              f"losses by (fold, epoch) " + ", ".join(f"{r['train_loss']:.4f}" for r in logged)
              + f"; fold 0 test features vs plain from the .pth rel err {err:.3g} (tol {ENGINE_TOL[dtype]})",
              flush=True)
        if dtype == "bfloat16":
            ext = split_dir.parent / "moco_extract"
            last, ext_wall, counts = run_cli(["moco-extract", *common, "--work-dir", str(ext), "--checkpoint",
                                              str(work)], "moco-extract")
            check(counts == {("packed_flash_fwd", (*key, dtype)): 12 * slab_count},
                  f"moco-extract launched {counts}")
            names = sorted(os.listdir(work / "ssl_features_dir"))
            check(names == sorted(os.listdir(ext / "ssl_features_dir")) and len(names) == 4 * folds
                  and all(np.array_equal(np.load(work / "ssl_features_dir" / n), np.load(ext / "ssl_features_dir" / n))
                          for n in names), "moco-extract's files differ from moco-kfold's dumps")
            print(f"moco-extract bf16 ({card}): exit 0 in {ext_wall:.2f} s, {slab_count} slabs; its "
                  f"{len(names)} files equal moco-kfold's bitwise", flush=True)
            shutil.rmtree(ext)
        shutil.rmtree(work)
        gc.collect()
        torch.cuda.empty_cache()

    work = split_dir.parent / "moco_resnet"
    with Spans(spans) as timed:
        last, wall, counts = run_cli(["moco-kfold", *common, "--work-dir", str(work), "--epochs", "1",
                                      "--moco-arch", "resnet"], "moco-kfold --moco-arch resnet")
    check(totals(counts) == NO_LAUNCHES, f"moco-kfold --moco-arch resnet launched {totals(counts)}")
    results = json.loads(last)
    check(sorted(results) == ["0", "1"] and all(np.isfinite(r["min_loss"]) for r in results.values()),
          f"moco-kfold resnet results {results}")
    features(work, 512, "moco-kfold resnet")
    print(f"moco-kfold --moco-arch resnet bf16 ({card}): {timed.line(wall)}; {folds * (fold_vols // BATCH)} "
          f"steps, no custom kernel launched", flush=True)
    shutil.rmtree(work)
    print(f"moco-kfold phase {time.perf_counter() - t0:.1f}s", flush=True)


# phase 5h: `contrastive-train`, the two-view SimSiam ViT (ViT-B trunk at
# 96^3 / patch 8 with global pooling, the predictor 768-768-768; with
# --use-proj the projector too), its step at batch 8 from the port's seeded
# init: both views through the trunk, 24 packed forward and 24 packed
# backward launches at B8 H12 N1729 d64 a step.
CONTR_GRADS = ("trunk.blocks.0.attn.qkv.weight", "trunk.blocks.11.mlp.fc2.weight", "trunk.patch_embed.proj.weight",
               "heads.predictor.0.weight")
CONTR_STATS = ("heads.predictor.1.running_mean", "heads.predictor.1.running_var")
@functools.lru_cache(maxsize=None)
def contrastive_sd() -> dict:
    """The contrastive ViT-B's state dict on the host, from the port's
    `init_weights` at seed 85, made once a process (every process makes the
    same)."""
    import torch

    from vit_ae_plus_plus_torch.configs import ViTConfig
    from vit_ae_plus_plus_torch.models import VisionTransformer3DContrastive

    model = VisionTransformer3DContrastive(ViTConfig(volume_size=VOLUME, patch_size=PATCH))
    return model.init_weights(torch.Generator().manual_seed(85)).state_dict()


def contrastive_views(device="cuda") -> list:
    """The step's seeded (original, augmented) batch of 8, f32: noise over an
    intensity offset of its own for each volume, -1.75 to 1.75, the same in
    both views. On noise alone the trunk's pooled features of the 8 volumes
    nearly coincide, the heads' BatchNorm divides by their tiny spread, and
    bf16 rounding alone then moves the gradients by 0.25-0.52 of their size
    (the plain step on its views nudged by 2^-20, an H100), as in the MoCo
    step: a gate there reads noise, not the kernels."""
    import torch

    rng = np.random.default_rng(86)
    offsets = (np.arange(BATCH) - (BATCH - 1) / 2) * 0.5
    return [torch.from_numpy((rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME))
                              + offsets[:, None, None, None, None]).astype(np.float32)).to(device)
            for _ in range(2)]


class ContrastiveTrainer:
    """One `contrastive-train` run of the port's public API on the card:
    `VisionTransformer3DContrastive` (ViT-B at 96^3 / patch 8, global
    pooling, no projector) loaded from `contrastive_sd()`, the unmasked
    AdamW (`AdamW(..., decay_mask=decay_everything)`, TrainConfig's
    blr x 8 / 256 and weight decay, no warmup), `make_contrastive_step`."""

    def __init__(self, dtype: str, attn_impl: str):
        from vit_ae_plus_plus_torch.configs import TrainConfig, ViTConfig
        from vit_ae_plus_plus_torch.models import VisionTransformer3DContrastive
        from vit_ae_plus_plus_torch.pipelines.contrastive import ContrastiveState, make_contrastive_step
        from vit_ae_plus_plus_torch.train.optim import AdamW, decay_everything

        tc = TrainConfig()
        self.label = f"{dtype} {attn_impl}"
        cfg = ViTConfig(volume_size=VOLUME, patch_size=PATCH, dtype=dtype, attn_impl=attn_impl)
        self.model = VisionTransformer3DContrastive(cfg)
        self.model.load_state_dict(contrastive_sd(), strict=True)
        self.model.cuda()
        tx = AdamW(self.model, tc.blr * BATCH / 256, tc.weight_decay, decay_mask=decay_everything)
        self.state = ContrastiveState(model=self.model, tx=tx)
        self.step = make_contrastive_step(self.model)

    def run(self, original, augmented) -> tuple:
        """One step, counts set to 0 before and read after. -> ({loss,
        CONTR_GRADS, CONTR_STATS} on the card in f32, launch counts by
        (wrapper, shape))."""
        import torch

        from vit_ae_plus_plus_torch.kernels import reset_launch_counts

        reset_launch_counts()
        self.state, metrics = self.step(self.state, original, augmented)
        out = {"loss": float(metrics["loss"])}
        counts = shape_counts()
        named, bufs = dict(self.model.named_parameters()), dict(self.model.named_buffers())
        out.update({n: named[n].grad.float().clone() for n in CONTR_GRADS})
        out.update({n: bufs[n].float().clone() for n in CONTR_STATS})
        check(np.isfinite(out["loss"]) and all(bool(torch.isfinite(p.grad).all()) for p in self.model.parameters()),
              f"contrastive {self.label} step: non-finite loss or gradients")
        return out, counts


def contrastive_launches(dtype: str, batch: int) -> dict:
    """One contrastive step's attention launches: both views through the
    trunk's 12 blocks, forward and backward."""
    key = (batch, 12, (VOLUME // PATCH) ** 3 + 1, 64, dtype)
    return {("packed_flash_fwd", key): 24, ("packed_flash_bwd", key): 24}


def contrastive_step_phase(rows: list) -> dict:
    """Phase 5h (a): the full-width contrastive step (B8 H12 N1729 d64) with
    attn_impl="auto" (the packed kernels) against "plain" from the same
    weights and views (`contrastive_views`), in f32 and bf16, each reading
    a tensor's largest error over its largest magnitude: in f32 the loss,
    CONTR_GRADS and CONTR_STATS within STEP_TOL; in bf16 CONTR_STATS within
    STEP_TOL, the loss and the gradients within STEP_TOL or
    MOCO_FLOOR_FACTOR times the plain step's floor (its views scaled by
    1 + 2^-20), whichever is larger, as phase 5g holds the MoCo-ResNet:
    bf16 rounding alone puts that floor at 6e-4 on the loss and 0.06-0.19
    on the gradients, above STEP_TOL (an H100). The launches around the
    step (24 + 24, into the kernel rows' `contrastive_launches`); beside
    the card, ms per step
    and volumes/s (CUDA events) and peak memory. -> the f32 kernel step's
    readings on the host, which phase 7d(f)'s ranks are held to."""
    import torch

    t0 = time.perf_counter()
    card = card_line()
    views = contrastive_views()
    times, peak, ref = {}, {}, None
    for dtype in ("float32", "bfloat16"):
        tol = STEP_TOL[dtype]
        want, counts = ContrastiveTrainer(dtype, "plain").run(*views)
        check(totals(counts) == NO_LAUNCHES, f"plain {dtype} contrastive step launched {totals(counts)}")
        floor = moco_errs(ContrastiveTrainer(dtype, "plain").run(*[v * (1 + 2**-20) for v in views])[0], want)
        base_bytes = reset_peak()
        trainer = ContrastiveTrainer(dtype, "auto")
        got, counts = trainer.run(*views)
        want_counts = contrastive_launches(dtype, BATCH)
        check(counts == want_counts, f"contrastive {dtype} step launched {counts} (want {want_counts})")
        for row in rows:
            n = counts.get((row["name"], row["key"]), 0)
            if n:
                row["contrastive_launches"] = n
                row["contrastive_path"] = f"make_contrastive_step, one {dtype} step of {BATCH}"
        errs = moco_errs(got, want)
        limits = {k: tol["loss"] if k == "loss" else tol["grad"] for k in errs}
        if dtype == "bfloat16":
            limits.update({k: max(limits[k], MOCO_FLOOR_FACTOR * floor[k]) for k in ("loss", *CONTR_GRADS)})
        print(f"contrastive step {dtype} auto vs plain: " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
              + " (limits " + ", ".join(f"{k} {v:.3g}" for k, v in limits.items()) + ": STEP_TOL"
              + (f", or {MOCO_FLOOR_FACTOR} times the floor on the loss and gradients" if dtype == "bfloat16" else "")
              + "); the plain step's floor: " + ", ".join(f"{k} {e:.3g}" for k, e in floor.items()), flush=True)
        bad = {k: e for k, e in errs.items() if e > limits[k]}
        check(not bad, f"contrastive step {dtype} auto vs plain: {bad}")
        if dtype == "float32":
            ref = on_host(got)

        def one():
            trainer.state, _ = trainer.step(trainer.state, *views)

        times[dtype] = cuda_ms(one, reps=3, warmup=1)
        peak[dtype] = (torch.cuda.max_memory_allocated() - base_bytes) / 2**30
        del trainer
        reset_peak()
    print(f"contrastive steps ({card}, CUDA events, batch {BATCH}, ViT-B at 96^3, 2 trunk passes of 1,729 tokens, "
          f"24 + 24 attention launches a step): bf16 {times['bfloat16']:.2f} ms "
          f"({BATCH / times['bfloat16'] * 1e3:.1f} volumes/s), f32 {times['float32']:.2f} ms "
          f"({BATCH / times['float32'] * 1e3:.1f} volumes/s); peak memory above the weights bf16 "
          f"{peak['bfloat16']:.2f} GiB, f32 {peak['float32']:.2f} GiB", flush=True)
    print(f"contrastive step phase {time.perf_counter() - t0:.1f}s", flush=True)
    return ref


def contrastive_command_phase(split_dir: Path) -> None:
    """Phase 5h (b): the port's `contrastive-train` command on phase 5c's
    split (48 volumes: 6 steps of 8 an epoch), 2 epochs in its default
    bf16, without and with `--use-proj`, counts read around each run.
    Checks: exit 0; the result's keys; 2 finite `log.txt` rows, the min
    loss theirs; the min-loss `.pth` loads into the model; the attention
    launches by shape (12 steps of 24 forward and 24 backward). Prints the
    wall time by span beside the card."""
    import torch

    from vit_ae_plus_plus_torch.configs import ViTConfig
    from vit_ae_plus_plus_torch.models import VisionTransformer3DContrastive
    from vit_ae_plus_plus_torch.pipelines import contrastive as tc

    t0 = time.perf_counter()
    card = card_line()
    epochs, steps = 2, 2 * (DATA_VOLUMES // BATCH)
    spans = [(tc, "train_epoch", "training epochs"), (tc, "save_state_dict", "min-loss writes")]
    for use_proj in (False, True):
        work = split_dir.parent / f"contrastive_{int(use_proj)}"
        argv = ["contrastive-train", "--data-path", str(split_dir), "--work-dir", str(work), "--volume-size",
                str(VOLUME), "--batch-size", str(BATCH), "--epochs", str(epochs)] + (["--use-proj"] if use_proj else [])
        label = "contrastive-train" + (" --use-proj" if use_proj else "")
        with Spans(spans) as timed:
            last, wall, counts = run_cli(argv, label)
        result = json.loads(last)
        with open(work / "log.txt") as f:
            logged = [json.loads(line) for line in f]
        check(sorted(result) == ["checkpoint", "min_loss"] and [r["epoch"] for r in logged] == list(range(epochs))
              and all(np.isfinite(r["train_loss"]) for r in logged)
              and result["min_loss"] == min(r["train_loss"] for r in logged), f"{label}: {result}, log.txt {logged}")
        model = VisionTransformer3DContrastive(ViTConfig(volume_size=VOLUME, patch_size=PATCH), use_proj=use_proj)
        model.load_state_dict(torch.load(result["checkpoint"], map_location="cpu", weights_only=True), strict=True)
        want = {k: steps * n for k, n in contrastive_launches("bfloat16", BATCH).items()}
        check(counts == want, f"{label} launched {counts} (want {want})")
        print(f"{label} bf16 ({card}): {timed.line(wall)}; {steps} steps; losses by epoch "
              + ", ".join(f"{r['train_loss']:.6f}" for r in logged) + "; the .pth loads", flush=True)
        shutil.rmtree(work)
    print(f"contrastive command phase {time.perf_counter() - t0:.1f}s", flush=True)


# phase 5i: the pretraining options off the default path. (a) the
# augmentation on the card against its CPU run with the same draws, on the
# CPU for the first AUG_CPU_ROWS volumes of each batch: f32 on both sides
# in another order, every voxel within AUG_TOL of the view's largest
# magnitude (the shear's twelve passes each blend two taps; an H100 reads
# 3e-7). The gather path's sample points are 3x3 products, which the card
# and the CPU may round one spacing apart (7.6e-6 at 95), and a noise
# volume changes by up to its largest magnitude from voxel to voxel, so
# it is held to AUG_GATHER_TOL (an H100 reads 1.4e-5); a point rounded to
# the other side of the volume's edge, where the sampler jumps to 0, may
# put a share AUG_EDGE_SHARE of the voxels past that
AUG_TOL = {"shear": 1e-5, "gather": 1e-4}
AUG_EDGE_SHARE = 1e-5
AUG_CPU_ROWS = 2
EGD_CHANNELS = 4
# (c) the perceptual term on the f32 step's prediction and target against
# the same seeded VGG16 in f64 on the card, over the first PERCEPTUAL_ROWS
# volumes, relative; the same term with TF32 convolutions must miss it.
# On an H100 the f32 term reads 8.6e-8 and the TF32 control 7.8e-6: the
# term is an MSE of differences of two views' taps, both rounded alike
PERCEPTUAL_WEIGHT = 0.1
PERCEPTUAL_ROWS = 2
PERCEPTUAL_TOL = 1e-6
# (c') the opt-in `perceptual_differentiable=True` keeps the VGG's
# activations of every slice of the prediction for the backward (about
# 12 GB at phase 5's batch of 8, by count), so it runs on phase 5's model
# and views cut to PERCEPTUAL_GRAD_BATCH volumes
PERCEPTUAL_GRAD_BATCH = 4
# (e) the command's epochs at batch 8 on 5c's split (2 folds of 24 training
# volumes: 3 steps an epoch), with accum_iter 2 through TrainConfig
OPTIONS_EPOCHS, OPTIONS_ACCUM = 1, 2


def augment_phase() -> None:
    """Phase 5i (a): `device_augment_batch` on seeded raw batches of 8 at
    96^3, BraTS (one channel, whole-volume z-score) and EGD (four
    channels, per-channel z-score), the shear and the gather path, on the
    card against its CPU run on the first AUG_CPU_ROWS volumes with the same
    draws (`augment_draws` from a generator on the card). Prints the ms per
    batch of 8 by CUDA events."""
    import torch

    from vit_ae_plus_plus_torch.ops.augment import augment_draws, device_augment_batch

    t0 = time.perf_counter()
    card = card_line()
    rng = np.random.default_rng(71)
    for label, c, per_channel in (("BraTS", 1, False), ("EGD", EGD_CHANNELS, True)):
        raw = torch.from_numpy(rng.standard_normal((BATCH, c, VOLUME, VOLUME, VOLUME), dtype=np.float32) * 2 + 3).cuda()
        draws = augment_draws(torch.Generator(device="cuda").manual_seed(72), raw.shape, device="cuda")
        cpu_draws = {k: v[:AUG_CPU_ROWS].cpu() for k, v in draws.items()}
        for method in ("shear", "gather"):
            run = functools.partial(device_augment_batch, raw, draws=draws, per_channel=per_channel, method=method)
            views = run()
            synced(f"augment {label} {method}")
            want = device_augment_batch(raw[:AUG_CPU_ROWS].cpu(), draws=cpu_draws, per_channel=per_channel,
                                        method=method)
            readings = []
            for name, got, ref in zip(("augmented", "original"), views, want):
                got, ref = got.cpu().numpy(), ref.numpy()
                check(got.shape == (BATCH, c, VOLUME, VOLUME, VOLUME) and bool(np.isfinite(got).all()),
                      f"augment {label} {method} {name}: {got.shape}")
                dev = np.abs(got[:AUG_CPU_ROWS] - ref) / np.abs(ref).max()
                share = float((dev > AUG_TOL[method]).mean())
                readings.append(f"{name} largest {float(dev.max()):.3g}, share past tol {share:.3g}")
                check(share <= (AUG_EDGE_SHARE if method == "gather" else 0.0),
                      f"augment {label} {method} {name} on the card vs the CPU: {readings[-1]}")
            ms = cuda_ms(run, reps=3, warmup=1)
            print(f"augment {label} ({c} channel{'s' * (c > 1)}) {method} on the card vs the CPU, same draws, "
                  f"{AUG_CPU_ROWS} volumes: " + "; ".join(readings)
                  + f" (tol {AUG_TOL[method]}, edge share {AUG_EDGE_SHARE if method == 'gather' else 0}); "
                  f"{ms:.2f} ms per batch of {BATCH} ({card}, CUDA events over 3 batches)", flush=True)
        del raw, draws
    print(f"augment phase {time.perf_counter() - t0:.1f}s", flush=True)


def resident_phase(split_dir: Path, step_times: dict) -> None:
    """Phase 5i (b): 5c's split's 48 raw volumes resident on the card
    (`DeviceResidentBatches`, seed 0) feed phase 5's full-width step through
    `device_augment_batch` (the draws seeded as `pretrain_kfold` seeds them),
    in f32 and in bf16: one warm-up and TIMED_STEPS timed steps an epoch.
    Checks: one epoch's batches are `Loader`'s over the same raw dataset,
    bitwise; every step launches phase 5's attention kernels by shape;
    every metric finite. Prints ms per step, volumes/s, the augmentation's
    share, and the device's idle share of a fed step beside 5c's
    loader-fed and resident-views steps."""
    import torch

    from vit_ae_plus_plus_torch.data import BraTSDataset, Loader
    from vit_ae_plus_plus_torch.data.loader import DeviceResidentBatches
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.ops.augment import device_augment_batch
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import augment_seed

    t0 = time.perf_counter()
    card = card_line()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    raw = BraTSDataset(str(split_dir), "whole", raw=True)
    resident = DeviceResidentBatches(raw, BATCH, seed=0, device="cuda")
    check(len(resident) == 1 + TIMED_STEPS, f"{len(resident)} resident batches an epoch")
    loader = Loader(raw, BATCH, seed=0, num_workers=8)
    for b, ((got, same, _), (want, _, _)) in enumerate(zip(resident, loader)):
        check(got is same and np.array_equal(got.cpu().numpy(), want), f"resident batch {b} is not Loader's")
    print(f"resident data ({card}): {resident.nbytes() / 1e9:.3f} GB on the card; epoch 1's {len(resident)} "
          "batches equal Loader's over the same raw volumes", flush=True)
    gen = torch.Generator(device="cuda")
    for dtype in ("float32", "bfloat16"):
        trainer = Trainer(tree, stats, dtype, "auto")
        want_step = step_launches(cfg, "packed_flash", dtype)
        epoch = [0]
        batches = iter(())
        metrics_all, aug_ms = [], []

        def fed_step():
            nonlocal batches
            item = next(batches, None)
            if item is None:
                epoch[0] += 1
                batches = enumerate(resident)
                item = next(batches)
            count, (batch, _, _) = item
            gen.manual_seed(augment_seed(42, 0, epoch[0], count))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            aug, orig = device_augment_batch(batch, gen)
            end.record()
            aug_ms.append((start, end))
            reset_launch_counts()
            trainer.state, metrics = trainer.step(trainer.state, aug, orig, trainer.emw)
            counts = shape_counts()
            check(counts == want_step, f"{dtype} resident fed step launched {counts} (want {want_step})")
            metrics_all.append(metrics)

        fed_step()  # warm-up, the epoch's first batch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(TIMED_STEPS):
            fed_step()
        end.record()
        torch.cuda.synchronize()
        fed_ms = start.elapsed_time(end) / TIMED_STEPS
        augment_ms = [s.elapsed_time(e) for s, e in aug_ms[1:]]
        for i, m in enumerate(metrics_all):
            m = {k: float(v) for k, v in m.items()}
            check(all(np.isfinite(v) for v in m.values()), f"{dtype} resident fed step {i + 1}: {m}")
        busy = profile_run(fed_step, f"{dtype} resident fed step", fed_ms)
        print(f"resident fed step {dtype} ({card}): {fed_ms:.2f} ms per step of {BATCH} (CUDA events over "
              f"{TIMED_STEPS} steps after one warm-up, the augmentation included), {BATCH / fed_ms * 1e3:.1f} "
              f"volumes/s; augmentation ms per batch {mean_max(augment_ms)}; device idle "
              f"{1 - busy / fed_ms:.1%} of a fed step; phase 5c: loader-fed {step_times[dtype]['fed']:.2f} ms, "
              f"resident views {step_times[dtype]['resident']:.2f} ms", flush=True)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    del resident
    print(f"resident phase {time.perf_counter() - t0:.1f}s", flush=True)


@contextlib.contextmanager
def tf32_vgg():
    """The TF32 control of phase 5i (c): the VGG's `conv_precision()` made
    to allow TF32, as cuDNN does by default."""
    from vit_ae_plus_plus_torch.models import vgg

    cudnn = vgg.torch.backends.cudnn
    real = vgg.conv_precision
    vgg.conv_precision = lambda: cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                                             deterministic=cudnn.deterministic, allow_tf32=True)
    try:
        yield
    finally:
        vgg.conv_precision = real


def perceptual_case() -> None:
    """Phase 5i (c): phase 5's f32 step (weights, views, noise) with the
    VGG16 term at PERCEPTUAL_WEIGHT, seeded VGG weights
    (`build_perceptual(seed=0)`). Checks: phase 5's launches, finite
    metrics, the logged term PERCEPTUAL_WEIGHT times the term recomputed on
    the step's prediction and target; that term on the first
    PERCEPTUAL_ROWS volumes against the same VGG in f64 within
    PERCEPTUAL_TOL, which the term with TF32 convolutions must miss; the
    step's gradients (GRAD_NAMES) within STEP_TOL["float32"] of the
    term-free step's (the term is gradient-free). Prints the step's ms and
    peak memory with and without the term."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_perceptual, make_perceptual_fn

    t0 = time.perf_counter()
    card = card_line()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    vgg, fn = build_perceptual(seed=0, device="cuda")
    seen = []

    def term(pred_vol, target_vol):
        if not seen:
            seen.append((pred_vol.detach().clone(), target_vol.detach().clone()))
        return fn(pred_vol, target_vol)

    plain = Trainer(tree, stats, "float32", "auto")
    (m0, counts0) = plain.run(views, noise[0])
    g0 = plain.grads()
    plain_resident = reset_peak()
    plain_ms, _ = step_ms(plain, views, reps=3)
    plain_peak = torch.cuda.max_memory_allocated()
    del plain
    with_term = Trainer(tree, stats, "float32", "auto", perceptual_fn=term, perceptual_weight=PERCEPTUAL_WEIGHT)
    m1, counts1 = with_term.run(views, noise[0])
    want_step = step_launches(cfg, "packed_flash", "float32")
    check(counts0 == counts1 == want_step, f"f32 step with the perceptual term launched {counts1}")
    pred, target = seen[0]
    with torch.no_grad():
        full = float(fn(pred, target))
        sub = float(fn(pred[:PERCEPTUAL_ROWS], target[:PERCEPTUAL_ROWS]))
        f64 = float(make_perceptual_fn(copy.deepcopy(vgg).double())(pred[:PERCEPTUAL_ROWS].double(),
                                                                   target[:PERCEPTUAL_ROWS].double()))
        with tf32_vgg():
            tf32 = float(fn(pred[:PERCEPTUAL_ROWS], target[:PERCEPTUAL_ROWS]))
    logged = m1["perceptual_loss"]
    err, err_tf32 = abs(sub - f64) / f64, abs(tf32 - f64) / f64
    grad_errs = {n: float((g - g0[n]).abs().max() / g0[n].abs().max()) for n, g in with_term.grads().items()}
    print(f"perceptual term f32 ({card}): logged {logged:.6g} = {PERCEPTUAL_WEIGHT} x {full:.6g} (rel "
          f"{abs(logged - PERCEPTUAL_WEIGHT * full) / (PERCEPTUAL_WEIGHT * full):.3g}); on {PERCEPTUAL_ROWS} "
          f"volumes ({PERCEPTUAL_ROWS * VOLUME} slices) against f64: rel err {err:.3g} (tol {PERCEPTUAL_TOL}); "
          f"TF32 control {err_tf32:.3g} (must miss); gradients vs the term-free step "
          + ", ".join(f"{n} {v:.3g}" for n, v in grad_errs.items()) + f"; loss {m1['loss']:.6f} vs "
          f"{m0['loss']:.6f} without", flush=True)
    check(abs(logged - PERCEPTUAL_WEIGHT * full) <= 1e-5 * PERCEPTUAL_WEIGHT * full and logged > 0,
          f"the logged perceptual term {logged} is not {PERCEPTUAL_WEIGHT} x {full}")
    check(err <= PERCEPTUAL_TOL, f"perceptual term f32 vs f64: rel err {err:.3g}")
    check(err_tf32 > PERCEPTUAL_TOL, f"the TF32 control passed the perceptual gate: {err_tf32:.3g}")
    check(max(grad_errs.values()) <= STEP_TOL["float32"]["grad"], f"the term moved the gradients: {grad_errs}")
    term_resident = reset_peak()
    term_ms, timed = step_ms(with_term, views, reps=3)
    term_peak = torch.cuda.max_memory_allocated()
    check(timed == {k: 3 * n for k, n in want_step.items()}, f"3 timed f32 steps with the term launched {timed}")
    print(f"perceptual step f32 ({card}): {term_ms:.2f} ms per step of {BATCH} with the term, {plain_ms:.2f} "
          f"without (CUDA events over 3 steps), max_memory_allocated {term_peak / 2**30:.2f} GiB "
          f"({term_resident / 2**30:.2f} before the steps), without {plain_peak / 2**30:.2f} GiB "
          f"({plain_resident / 2**30:.2f})", flush=True)
    del with_term, vgg
    gc.collect()
    torch.cuda.empty_cache()
    print(f"perceptual phase {time.perf_counter() - t0:.1f}s", flush=True)


def perceptual_grad_case() -> None:
    """Phase 5i (c'): `mae_loss_terms(..., perceptual_differentiable=True)`,
    the opt-in that lets the VGG term's gradient through, on phase 5's f32
    model, views and noise cut to PERCEPTUAL_GRAD_BATCH volumes, seeded VGG
    weights. One forward and backward each without the term, with the
    default (no_grad) term and with the term's gradient. Checks: each
    pass's attention launches (one forward and one backward per block);
    finite gradients; the through pass's gradients (GRAD_NAMES) minus the
    term-free pass's within STEP_TOL["float32"] of the term's own gradient
    (taken by `autograd.grad` of the weighted term in a through pass),
    which the default mode's gradients must miss. Prints each pass's ms
    (CUDA events, after a warm-up pass) and peak memory."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_perceptual
    from vit_ae_plus_plus_torch.ops import at_least_f32
    from vit_ae_plus_plus_torch.train.objective import mae_loss_terms

    t0 = time.perf_counter()
    card = card_line()
    b = PERCEPTUAL_GRAD_BATCH
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    views, noise = [v[:b] for v in views], noise[0][:2 * b]
    trainer = Trainer(tree, stats, "float32", "auto")
    model, kw = trainer.model, trainer.kw
    named = dict(model.named_parameters())
    _, fn = build_perceptual(seed=0, device="cuda")
    depth = cfg.depth + cfg.decoder_depth
    recorded = []

    def term(pred_vol, target_vol):
        value = fn(pred_vol, target_vol)
        recorded.append(value)
        return value

    def one_pass(mode: str, term_grads: bool = False):
        """-> (GRAD_NAMES gradients, launches by wrapper)."""
        model.zero_grad(set_to_none=True)
        recorded.clear()
        reset_launch_counts()
        outputs = model(*views, noise=noise)
        total, _ = mae_loss_terms(
            outputs, at_least_f32(views[0]), PATCH, edge_map_weight=trainer.emw, contr_weight=kw["contr_weight"],
            perceptual_weight=0.0 if mode == "free" else PERCEPTUAL_WEIGHT,
            perceptual_fn=None if mode == "free" else term, perceptual_differentiable=mode == "through")
        got = {}
        if term_grads:
            got = dict(zip(GRAD_NAMES, torch.autograd.grad(
                PERCEPTUAL_WEIGHT * recorded[0], [named[n] for n in GRAD_NAMES], retain_graph=True)))
        total.backward()
        return (got or {n: named[n].grad.clone() for n in GRAD_NAMES}), totals(shape_counts())

    runs = {}
    for mode in ("free", "no_grad", "through"):
        one_pass(mode)  # warm-up
        reset_peak()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grads, counts = one_pass(mode)
        end.record()
        torch.cuda.synchronize()
        runs[mode] = (grads, counts, start.elapsed_time(end), torch.cuda.max_memory_allocated())
        check(counts["packed_flash_fwd"] == counts["packed_flash_bwd"] == depth,
              f"the {mode} pass launched {counts}")
        check(all(bool(torch.isfinite(g).all()) for g in grads.values()), f"the {mode} pass's gradients")
    g_term, _ = one_pass("through", term_grads=True)
    g_free, g_default, g_through = (runs[m][0] for m in ("free", "no_grad", "through"))

    def rel(a, b_, n):
        return float((a[n] - b_[n]).abs().max() / g_through[n].abs().max())

    errs = {n: rel(g_through, {n: g_free[n] + g_term[n]}, n) for n in GRAD_NAMES}
    control = {n: rel(g_through, g_default, n) for n in GRAD_NAMES}
    share = {n: float(g_term[n].abs().max() / g_through[n].abs().max()) for n in GRAD_NAMES}
    tol = STEP_TOL["float32"]["grad"]
    print(f"perceptual gradient f32 ({card}), batch {b}: through minus term-free vs the term's own gradient "
          + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()) + f" (tol {tol}); the default no_grad mode "
          + ", ".join(f"{n} {v:.3g}" for n, v in control.items()) + " (must miss); the term's share of the "
          "gradient " + ", ".join(f"{n} {v:.3g}" for n, v in share.items()), flush=True)
    print(f"perceptual passes f32 ({card}), batch {b}, one forward and backward by CUDA events: "
          + "; ".join(f"{m} {r[2]:.2f} ms, max_memory_allocated {r[3] / 2**30:.2f} GiB" for m, r in runs.items()),
          flush=True)
    check(max(errs.values()) <= tol, f"the through pass's gradients are not the term-free pass's plus the "
          f"term's: {errs}")
    check(max(control.values()) > tol, f"the default mode passed the gradient-through gate: {control}")
    del trainer, model, named, fn, runs, g_term, g_free, g_default, g_through
    recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"perceptual gradient phase {time.perf_counter() - t0:.1f}s", flush=True)


def accum_errs(trainer, p0: dict, ref) -> dict:
    """The accumulating trainer's update against `ref`'s (one AdamW update
    on the mean of the two gradients): each GRAD_NAMES parameter's move and
    AdamW first moment, over their largest magnitudes."""
    named, ref_named = dict(trainer.model.named_parameters()), dict(ref.model.named_parameters())
    errs = {}
    for n in GRAD_NAMES:
        move, want = named[n].detach() - p0[n], ref_named[n].detach() - p0[n]
        errs[f"{n} move"] = float((move - want).abs().max() / want.abs().max())
        m, want_m = (t.state.tx.opt.state[p]["exp_avg"] for t, p in ((trainer, named[n]), (ref, ref_named[n])))
        errs[f"{n} exp_avg"] = float((m - want_m).abs().max() / want_m.abs().max())
    return errs


def accum_case() -> None:
    """Phase 5i (d): phase 5's f32 step (weights, noise) with
    `make_adamw(accum_iter=2)`, two mini-steps on two batches (phase 5's
    views, then the same flipped along the last axis). Checks: after
    mini-step 1 every parameter bitwise unchanged and no update counted;
    after mini-step 2 one update, its parameter moves and AdamW first
    moments (GRAD_NAMES) within STEP_TOL["float32"] of one plain AdamW
    update, from the same start, on the mean of the two gradients (each
    taken by a plain step from that start). A control that sums the two
    gradients instead must miss."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.train.optim import MultiSteps

    t0 = time.perf_counter()
    card = card_line()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    batches = [(views, noise[0]), ([v.flip(-1) for v in views], noise[1])]
    grads = []
    for v, nz in batches:  # each gradient at the start, by a plain step
        plain = Trainer(tree, stats, "float32", "auto")
        plain.run(v, nz)
        grads.append({n: p.grad.clone() for n, p in plain.model.named_parameters()})
        del plain
    ref = Trainer(tree, stats, "float32", "auto")
    p0 = {n: p.detach().clone() for n, p in ref.model.named_parameters()}
    for n, p in ref.model.named_parameters():
        p.grad = grads[0][n] + (grads[1][n] - grads[0][n]) / 2
    ref.state.tx.step()
    del grads

    def two_mini_steps(trainer):
        trainer.run(*batches[0])
        check(trainer.state.tx.count == 0 and trainer.state.tx.mini_step == 1, "mini-step 1 counted an update")
        same = all(torch.equal(p.detach(), p0[n]) for n, p in trainer.model.named_parameters())
        trainer.run(*batches[1])
        check(trainer.state.tx.count == 1 and trainer.state.tx.mini_step == 0, "mini-step 2 did not update")
        return same, accum_errs(trainer, p0, ref)

    acc = Trainer(tree, stats, "float32", "auto", accum_iter=2)
    check(isinstance(acc.state.tx, MultiSteps), f"accum_iter=2 built {type(acc.state.tx).__name__}")
    same, errs = two_mini_steps(acc)
    del acc
    torch.cuda.empty_cache()

    class Summed(MultiSteps):  # the control: a sum of the gradients, optax's use_grad_mean=False
        def _acc_update(self, grads):
            torch._foreach_add_(self.acc, grads)

    summed = Trainer(tree, stats, "float32", "auto", accum_iter=2)
    summed.state.tx.__class__ = Summed
    _, control = two_mini_steps(summed)
    tol = STEP_TOL["float32"]["grad"]
    print(f"accumulation f32 ({card}): after mini-step 1 the parameters {'bitwise unchanged' if same else 'MOVED'}; "
          "after mini-step 2 against one AdamW update on the mean gradient: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {tol}); the summing control: "
          + ", ".join(f"{k} {v:.3g}" for k, v in control.items()) + " (must miss)", flush=True)
    check(same, "mini-step 1 moved the parameters")
    check(max(errs.values()) <= tol, f"accumulated update vs the mean gradient's: {errs}")
    check(max(control.values()) > tol, f"the summing control passed the accumulation gate: {control}")
    del summed, ref
    gc.collect()
    torch.cuda.empty_cache()
    print(f"accumulation phase {time.perf_counter() - t0:.1f}s", flush=True)


def options_command_phase(split_dir: Path) -> None:
    """Phase 5i (e): the port's `pretrain-kfold --device-data
    --perceptual-weight PERCEPTUAL_WEIGHT` on 5c's split in its default
    bf16, 2 folds of OPTIONS_EPOCHS epochs (3 steps of 8 each), with
    `accum_iter` OPTIONS_ACCUM set on the TrainConfig the CLI builds, counts
    read around the run. Checks: the flags reached the TrainConfig; exit 0;
    each fold's "dataset resident on the card" line; finite `log.txt` rows
    with a positive perceptual term; each fold's min-loss `.pth` loads;
    (24, 768) finite features with their labels; the attention launches by
    shape (12 steps of phase 5's plus 12 extraction slabs of 12)."""
    import torch

    from vit_ae_plus_plus_torch import cli
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    t0 = time.perf_counter()
    card = card_line()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    folds, fold_train = 2, DATA_VOLUMES // 2
    steps, slabs = folds * OPTIONS_EPOCHS * (fold_train // BATCH), fold_train // BATCH
    work = split_dir.parent / "pretrain_options"
    argv = ["pretrain-kfold", "--data-path", str(split_dir), "--work-dir", str(work), "--model", MODEL,
            "--volume-size", str(VOLUME), "--patch-size", str(PATCH), "--batch-size", str(BATCH),
            "--epochs", str(OPTIONS_EPOCHS), "--n-splits", str(folds), "--device-data",
            "--perceptual-weight", str(PERCEPTUAL_WEIGHT)]
    real, built = cli.configs_from_args, []

    def configs_from_args(args):
        data_cfg, train_cfg = real(args)
        built.append(train_cfg)
        return data_cfg, dataclasses.replace(train_cfg, accum_iter=OPTIONS_ACCUM)

    out = io.StringIO()
    cli.configs_from_args = configs_from_args
    reset_launch_counts()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    except BaseException:
        print("\n".join(out.getvalue().splitlines()[-20:]), file=sys.stderr)
        raise
    finally:
        cli.configs_from_args = real
    wall = time.perf_counter() - t
    counts = shape_counts()
    printed = out.getvalue().strip().splitlines()
    check(rc == 0, f"pretrain-kfold with the options exit {rc}: " + "\n".join(printed[-20:]))
    tc = built[0]
    check(tc.device_data and tc.device_augment and tc.perceptual_weight == PERCEPTUAL_WEIGHT,
          f"the flags did not reach the TrainConfig: {tc}")
    resident = [line for line in printed if "dataset resident on the card" in line]
    check(len(resident) == folds, f"resident lines {resident}")
    results = json.loads(printed[-1])
    with open(work / "checkpoints" / "log.txt") as f:
        rows = [json.loads(line) for line in f]
    check(sorted(results) == ["0", "1"] and [(r["fold"], r["epoch"]) for r in rows]
          == [(k, e) for k in range(folds) for e in range(OPTIONS_EPOCHS)]
          and all(np.isfinite(v) for r in rows for v in r.values())
          and all(r["train_perceptual_loss"] > 0 for r in rows), f"pretrain-kfold with the options: {rows}")
    labels = np.load(split_dir / "y_whole_ssl.npy")
    for k in range(folds):
        sd = load_reference_state_dict(str(work / "checkpoints" / f"fold_{k}" / "checkpoint-min_loss.pth"))
        check(sd["blocks.0.attn.qkv.weight"].dtype == torch.float32, f"fold {k} checkpoint")
        for tag in ("train", "test"):
            feats = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_features_split_{k}.npy")
            labs = np.load(work / "ssl_features_dir" / f"{tag}_contrast_ssl_labels_split_{k}.npy")
            ids = np.sort(np.load(work / "k_fold" / "indices_file" / f"{tag}_{k}.npy"))
            check(feats.shape == (fold_train, cfg.embed_dim) and bool(np.isfinite(feats).all())
                  and np.array_equal(labs, labels[ids]), f"fold {k} {tag} features {feats.shape}")
    want = {key: steps * n for key, n in step_launches(cfg, "packed_flash", "bfloat16").items()}
    slab_key = ("packed_flash_fwd", (BATCH, cfg.num_heads, cfg.num_patches + 1, cfg.embed_dim // cfg.num_heads,
                                     "bfloat16"))
    want[slab_key] = want.get(slab_key, 0) + folds * 2 * slabs * cfg.depth
    check(counts == want, f"pretrain-kfold with the options launched {counts} (want {want})")
    ms = [1e3 * BATCH / r["train_volumes_per_sec"] for r in rows]
    print(f"pretrain-kfold --device-data --perceptual-weight {PERCEPTUAL_WEIGHT}, accum_iter {OPTIONS_ACCUM}, bf16 "
          f"({card}): exit 0 in {wall:.1f}s; {resident[0].split(': ', 1)[1]}; ms per step by (fold, epoch) "
          + ", ".join(f"({r['fold']}, {r['epoch']}) {m:.2f}" for r, m in zip(rows, ms))
          + "; perceptual term by row " + ", ".join(f"{r['train_perceptual_loss']:.4g}" for r in rows)
          + f"; lr {rows[-1]['train_lr']:.4g} last; {steps} steps, {folds * 2 * slabs} slabs", flush=True)
    shutil.rmtree(work)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"options command phase {time.perf_counter() - t0:.1f}s", flush=True)


# phase 5j: the CUDA kernels one packed wrapper call runs in bf16
# (csrc/flash_fwd.cu: flash_fwd_wgmma_kernel; csrc/flash_bwd.cu:
# flash_bwd_delta_kernel, flash_bwd_dkdv_wgmma_kernel, flash_bwd_dq_wgmma_kernel)
KERNELS_PER_LAUNCH = {"packed_flash_fwd": 1, "packed_flash_bwd": 3}
PRETRAIN_STEPS = DATA_VOLUMES // 2 // BATCH  # phase 5d's steps an epoch: the profiled epoch's
SANITY_SAMPLES = 2
FAITHFUL_BATCH, FAITHFUL_STEPS = 4, 3  # the reference's batch (config.ini:28); timed steps


def recon_shapes(cfg) -> list:
    """(label, (B, H, N, d)) of one volume's MAE pass: the masked encoder
    over one view, then the decoder."""
    from vit_ae_plus_plus_torch.configs import TrainConfig

    kept = int(cfg.num_patches * (1 - TrainConfig().mask_ratio)) + 1
    return [("B1 N433 d64 (encoder, one volume)", (1, cfg.num_heads, kept, cfg.embed_dim // cfg.num_heads)),
            ("B1 N1729 d32 (decoder, one volume)", (1, cfg.decoder_num_heads, cfg.num_patches + 1,
                                                    cfg.decoder_embed_dim // cfg.decoder_num_heads))]


def cli_output(argv: list) -> tuple:
    """The port's CLI `run(argv)` (its exit code as a user sees it) in this
    process -> (exit code, stdout lines, stderr, wall seconds)."""
    from vit_ae_plus_plus_torch.cli import run as cli_run

    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_run(argv)
    return rc, out.getvalue().strip().splitlines(), err.getvalue(), time.perf_counter() - t


def profile_attrib_case(trace_dir: Path, cfg, card: str) -> None:
    """`profile-attrib --json` on the trace phase 5d's bf16 run wrote (the
    newest: fold 1's profiled epoch of PRETRAIN_STEPS steps). Checks: exit
    0; the buckets sum to the device events' time recounted from the trace
    (float rounding only); the attention bucket holds the `flash_*`
    kernels and nothing else; its kernels a step equal the packed
    wrappers' launches a step (phase 5's) times KERNELS_PER_LAUNCH."""
    from vit_ae_plus_plus_torch.utils import profile_tools

    rc, lines, err, wall = cli_output(["profile-attrib", "--trace-dir", str(trace_dir), "--steps",
                                       str(PRETRAIN_STEPS), "--json"])
    check(rc == 0, f"profile-attrib exit {rc}: {err[-2000:]}")
    table = json.loads(lines[-1])
    (trace,) = profile_tools.find_trace_files(str(trace_dir))
    with open(trace) as f:
        events = json.load(f)
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in profile_tools.DEVICE_CATEGORIES]
    recount = sum(float(e.get("dur", 0.0)) for e in device) / 1e3 / PRETRAIN_STEPS
    buckets = sum(row["ms_per_step"] for b, row in table.items() if b != "__total__")
    check(bool(device) and abs(buckets - recount) <= 1e-9 * recount
          and abs(table["__total__"]["ms_per_step"] - recount) <= 1e-9 * recount,
          f"profile-attrib buckets {buckets} ms a step against the trace's device events {recount}")
    names = Counter(e["name"] for e in device)
    attention = {n: c for n, c in names.items() if profile_tools.bucket_of(n) == "attention kernels"}
    check(bool(attention) and all("flash_" in n for n in attention)
          and all(n in attention for n in names if "flash_" in n), f"attention bucket {sorted(attention)}")
    want = sum(n * KERNELS_PER_LAUNCH[name] for (name, _), n in step_launches(cfg, "packed_flash", "bfloat16").items())
    got = sum(attention.values()) / PRETRAIN_STEPS
    check(got == want, f"the trace's attention kernels a step {got} (want {want})")
    print(f"profile-attrib ({card}): exit 0 in {wall:.2f}s on {Path(trace).name} "
          f"({os.path.getsize(trace) / 1e6:.1f} MB, {len(device)} device events, {PRETRAIN_STEPS} steps); "
          f"attention kernels a step {got:g} = 20 packed forward x 1 + 20 packed backward x 3; buckets sum "
          f"{buckets:.4f} ms a step, recounted {recount:.4f}\n{profile_tools.format_table(table)}", flush=True)


def doctor_case(card: str) -> None:
    """`doctor` through the CLI after phase 1's build: exit 0, no FAIL."""
    rc, lines, err, wall = cli_output(["doctor"])
    check(rc == 0 and not any(line.startswith("[FAIL]") for line in lines),
          "doctor: " + "\n".join(lines) + err[-2000:])
    print(f"doctor ({card}): exit 0 in {wall:.2f}s\n  " + "\n  ".join(lines), flush=True)


@contextlib.contextmanager
def served_directory(root: Path):
    """`root` over HTTP on an ephemeral port of 127.0.0.1 -> its base URL."""
    import http.server

    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(root))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def export_case(resume: Path, tmp: Path, cfg, card: str) -> None:
    """`export-torch` on 5d's bf16 fold-0 resume directory, then on its
    checkpoint.pth through a file:// URL and through http:// from a server
    on 127.0.0.1 (the URLs cached under a HOME of the run's own). Checks:
    exit 0 and the printed count; the output loads strictly into the
    port's MAE (`load_exported_mae`) and equals the payload's model
    bitwise; the two URL exports equal it bitwise."""
    import torch

    from vit_ae_plus_plus_torch.models import build_model
    from vit_ae_plus_plus_torch.train.checkpoint import load_exported_mae

    common = ["--model", MODEL, "--volume-size", str(VOLUME), "--patch-size", str(PATCH)]

    def export(checkpoint: str, name: str):
        out = tmp / name
        rc, lines, err, wall = cli_output(["export-torch", "--checkpoint", checkpoint, "--out", str(out), *common])
        check(rc == 0, f"export-torch {checkpoint} exit {rc}: {err[-2000:]}")
        sd = torch.load(out, map_location="cpu", weights_only=True)
        check(json.loads(lines[-1]) == {"out": str(out), "tensors": len(sd)}, f"export-torch printed {lines[-1:]}")
        return sd, wall, os.path.getsize(out)

    payload = torch.load(resume / "checkpoint.pth", map_location="cpu", weights_only=True)["model"]
    sd, wall, size = export(str(resume), "export.pth")
    model = build_model(cfg)
    load_exported_mae(model, sd)
    own = model.state_dict()
    check(set(own) == set(payload) and all(torch.equal(v, payload[k]) for k, v in own.items()),
          "the export differs from the resume payload's model")
    home = os.environ.get("HOME")
    os.environ["HOME"] = str(tmp / "home")  # resolve_checkpoint_path's cache
    try:
        file_sd, file_wall, _ = export((resume / "checkpoint.pth").as_uri(), "export_file.pth")
        with served_directory(resume) as base:
            http_sd, http_wall, _ = export(f"{base}/checkpoint.pth", "export_http.pth")
    finally:
        if home is None:
            os.environ.pop("HOME")
        else:
            os.environ["HOME"] = home
    for how, other in (("file://", file_sd), ("http://", http_sd)):
        check(set(other) == set(sd) and all(torch.equal(other[k], v) for k, v in sd.items()),
              f"the {how} export differs from the directory's")
    print(f"export-torch ({card}): {len(sd)} tensors, {size / 1e6:.1f} MB from a "
          f"{os.path.getsize(resume / 'checkpoint.pth') / 1e6:.1f} MB resume file; loads strictly into the MAE, "
          f"equal to the payload bitwise; s: directory {wall:.2f}, file:// {file_wall:.2f}, http:// {http_wall:.2f} "
          "(each URL's first fetch into the cache included)", flush=True)


def sanity_case(split_dir: Path, pth: Path, rows: list, tmp: Path, cfg, card: str) -> None:
    """`sanity_viz.reconstruct` at full width in bf16 from 5d's fold-0
    min-loss `.pth` on SANITY_SAMPLES test volumes of 5c's split, sample i
    with seed i, against the same weights and noise with attn_impl="plain"
    (ENGINE_TOL["bfloat16"]); per volume 12 packed forward launches at the
    encoder's B1 shape and 8 at the decoder's, both shapes with phase 2
    rows, and nothing else; finite fractions; the first sample's
    `save_nifti` files read back. Then
    the `sanity-viz` command: with matplotlib, exit 0 and the PNGs; without
    it, exit 2 naming matplotlib before any model is built."""
    import importlib.util

    import vit_ae_plus_plus_torch.models as models
    from vit_ae_plus_plus_torch.configs import DataConfig
    from vit_ae_plus_plus_torch.data import get_dataset
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.pipelines import sanity_viz
    from vit_ae_plus_plus_torch.train.checkpoint import load_exported_mae, load_reference_state_dict
    from vit_ae_plus_plus_torch.utils.nifti import read_nifti

    sd = load_reference_state_dict(str(pth))

    def mae(attn_impl):
        m = models.build_model(MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH, dtype="bfloat16",
                                                attn_impl=attn_impl))
        load_exported_mae(m, sd)
        return m.cuda()

    kernel, plain = mae("auto"), mae("plain")
    want = {("packed_flash_fwd", (*shape, "bfloat16")): depth
            for (_, shape), depth in zip(recon_shapes(cfg), (cfg.depth, cfg.decoder_depth))}
    check(all(any(r["name"] == name and r["key"] == key for r in rows) for name, key in want),
          "a reconstruction shape has no phase 2 row")
    ds = get_dataset("brats", "test", DataConfig(base_path=str(split_dir)), transforms=None, use_z_score=True)
    errs, fractions = [], []
    for i in range(SANITY_SAMPLES):
        vol = ds[i][1][None]
        reset_launch_counts()
        got = sanity_viz.reconstruct(kernel, vol, seed=i)
        counts = shape_counts()
        check(counts == want, f"one volume's reconstruction launched {counts} (want {want})")
        fill_launches(rows, counts, "sanity_viz.reconstruct, one test volume (bf16, attn_impl='auto')")
        ref = sanity_viz.reconstruct(plain, vol, seed=i)
        check(np.array_equal(got["mask"], ref["mask"]), "the two models drew different masks")
        errs.append(rel_err(got["reconstruction"], ref["reconstruction"]))
        check(errs[-1] <= ENGINE_TOL["bfloat16"], f"reconstruction vs plain: rel err {errs[-1]:.3g}")
        fractions.append(sanity_viz.nonzero_fractions(got))
        check(all(np.isfinite(v) for v in fractions[-1].values()), f"fractions {fractions[-1]}")
        if i == 0:
            sanity_viz.save_nifti(got, str(tmp / "nifti"), sample_idx=0)
            for name in ("original", "masked", "reconstruction", "paste"):
                check(np.array_equal(read_nifti(str(tmp / "nifti" / f"{name}_0.nii.gz")), got[name][0, 0]),
                      f"NIfTI {name}")
    del kernel, plain

    have_mpl = importlib.util.find_spec("matplotlib") is not None
    viz, built = tmp / "sanity_viz", []
    real = models.build_model
    models.build_model = lambda cfg_: built.append(cfg_) or real(cfg_)
    try:
        rc, lines, err, wall = cli_output(
            ["sanity-viz", "--data-path", str(split_dir), "--work-dir", str(viz), "--checkpoint", str(pth),
             "--model", MODEL, "--volume-size", str(VOLUME), "--num-samples", str(SANITY_SAMPLES)])
    finally:
        models.build_model = real
    if have_mpl:
        slices = [f"sample0_slice{z:03d}.png" for z in range(0, VOLUME, 8)]
        check(rc == 0 and sorted(os.listdir(viz)) == slices and sorted(json.loads(lines[-1])) == ["0", "1"],
              f"sanity-viz exit {rc}: {err[-2000:]}")
        case = f"matplotlib present: exit 0, {len(slices)} PNGs, fractions {lines[-1]}"
    else:
        check(rc == 2 and "matplotlib" in err and not built and not viz.exists(),
              f"sanity-viz without matplotlib: exit {rc}, models built {len(built)}: {err[-2000:]}")
        case = f"matplotlib absent: exit 2 before any model build ({err.strip()})"
    print(f"sanity-viz ({card}): reconstruct bf16 vs plain rel err "
          + ", ".join(f"{e:.3g}" for e in errs) + f" (tol {ENGINE_TOL['bfloat16']}); fractions {fractions}; "
          f"NIfTI read back; the command: {case}, {wall:.2f}s", flush=True)


def faithful_case(step_ms: float, card: str) -> None:
    """The reference-faithful step (utils/ref_faithful.py) at full width,
    f32, FAITHFUL_BATCH volumes, the VGG forward on, from phase 5's
    weights, its first views and their noise rows, against the port's f32
    step with attn_impl="plain" on the same inputs: the loss terms and
    GRAD_NAMES within STEP_TOL["float32"]; the perceptual metric finite
    and positive (the port's step has no VGG and logs 0, by design). Then
    FAITHFUL_STEPS steps, each synchronised by its loss's read, and the
    peak memory; the analytic FLOPs of a step of 8 and phase 5's bf16
    step's MFU, information only."""
    import torch

    from vit_ae_plus_plus_torch.configs import TrainConfig
    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
    from vit_ae_plus_plus_torch.train import create_train_state, make_adamw
    from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
    from vit_ae_plus_plus_torch.utils.flops import H100_SXM_BF16_PEAK_FLOPS, flagship_step_flops
    from vit_ae_plus_plus_torch.utils.ref_faithful import make_reference_faithful_step

    tc = TrainConfig()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH, dtype="float32", attn_impl="plain")
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    b = FAITHFUL_BATCH
    views = [v[:b].contiguous() for v in views]
    n1, n2 = noise[0][:b].contiguous(), noise[0][BATCH:BATCH + b].contiguous()
    own = Trainer(tree, stats, "float32", "plain")
    own_metrics, _ = own.run(views, noise=torch.cat([n1, n2]))
    own_grads, emw = own.grads(), own.emw
    del own
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(tree, PATCH, 1, stats), strict=True)
    model.cuda()
    state = create_train_state(model, make_adamw(1e-4, weight_decay=tc.weight_decay), seed=0)
    step = make_reference_faithful_step(model, PATCH, mask_ratio=tc.mask_ratio, contr_weight=tc.contr_weight,
                                        run_vgg=True, noise=(n1, n2))
    state, metrics = step(state, *views, emw)
    metrics = {k: float(v) for k, v in metrics.items()}
    named = dict(model.named_parameters())
    grads = {n: named[n].grad.float().clone() for n in GRAD_NAMES}
    terms = ("loss", "edge_map_loss", "reconstruction_loss", "contr_loss")
    errs = step_rel_errs(metrics, {k: own_metrics[k] for k in terms}, grads, own_grads)
    tol = STEP_TOL["float32"]
    check(all(errs[k] <= tol["loss"] for k in terms if k in errs) and all(errs[n] <= tol["grad"] for n in GRAD_NAMES),
          f"faithful step vs the port's plain f32 step: {errs}")
    check(np.isfinite(metrics["perceptual_loss"]) and metrics["perceptual_loss"] > 0,
          f"perceptual metric {metrics['perceptual_loss']}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(FAITHFUL_STEPS):
        state, m = step(state, *views, emw)
        float(m["loss"])  # the reference's per-iteration sync
    ms = (time.perf_counter() - t) / FAITHFUL_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    flops = flagship_step_flops(BATCH)["total"]
    mfu = flops / (step_ms / 1e3) / H100_SXM_BF16_PEAK_FLOPS
    print(f"ref_faithful ({card}): vs the port's f32 step with attn_impl='plain', step 1: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (tol {tol}); perceptual metric "
          f"{metrics['perceptual_loss']:.6g} (the port's step: 0, no VGG); {FAITHFUL_STEPS} steps of {b} at f32 with "
          f"the VGG forward: {ms:.2f} ms a step with its sync ({b / ms * 1e3:.2f} volumes/s), peak {peak:.2f} GiB; "
          f"flagship_step_flops({BATCH})['total'] {flops:.6g}; phase 5c's resident bf16 step of {BATCH} "
          f"{step_ms:.2f} ms: MFU {mfu:.2%} of {H100_SXM_BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s", flush=True)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()


def tooling_phase(split_dir: Path, pre_work: Path, rows: list, step_times: dict, tmp: Path) -> None:
    """Phase 5j: the tooling commands on 5c's split and 5d's bf16 work dir
    (module docstring)."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    t0 = time.perf_counter()
    card = card_line()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    work = tmp / "tooling"
    work.mkdir()
    profile_attrib_case(pre_work / "profile", cfg, card)
    doctor_case(card)
    export_case(pre_work / "checkpoints" / "fold_0" / "resume", work, cfg, card)
    sanity_case(split_dir, pre_work / "checkpoints" / "fold_0" / "checkpoint-min_loss.pth", rows, work, cfg, card)
    faithful_case(step_times["bfloat16"]["resident"], card)
    shutil.rmtree(work)
    print(f"tooling phase {time.perf_counter() - t0:.1f}s", flush=True)


def fused_layernorm_run(rows: list, cfg) -> None:
    """The path of the LayerNorm kernels (#6): one forward and backward of
    `FusedLayerNorm` at the encoder's norm shape in the training step,
    counts set to 0 just before and read just after."""
    import torch

    from vit_ae_plus_plus_torch.kernels import layernorm_bwd_plain, reset_launch_counts
    from vit_ae_plus_plus_torch.kernels.fused_ln import compare, row_stats_plain
    from vit_ae_plus_plus_torch.models.vit import FusedLayerNorm

    (r, c) = ln_shapes(cfg)["encoder"]
    norm = FusedLayerNorm(c, eps=1e-6, dtype=torch.bfloat16).cuda()
    x, gamma, beta, dy = ln_operands(r, c, torch.bfloat16, seed=31)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    x = x.view(2 * BATCH, r // (2 * BATCH), c).requires_grad_()
    reset_launch_counts()
    y = norm(x)
    y.backward(dy.view(y.shape))
    torch.cuda.synchronize()
    counts = shape_counts()
    key = (r, c, "bfloat16")
    check(totals(counts) == {**NO_LAUNCHES, "layernorm_fwd": 1, "layernorm_bwd": 1}
          and counts.get(("layernorm_fwd", key)) == 1, f"FusedLayerNorm launched {counts}")
    fill_launches(rows, counts, f"FusedLayerNorm({c}) forward and backward at the encoder's (R, C)")
    mu, rstd = row_stats_plain(x.detach().view(r, c), 1e-6)
    err = compare(x.grad.view(r, c), layernorm_bwd_plain(x.detach().view(r, c), gamma, mu, rstd, dy))
    check(err["ok"] and norm.weight.grad is not None and bool(torch.isfinite(norm.weight.grad).all()),
          f"FusedLayerNorm gradients: {err}")
    print(f"FusedLayerNorm({c}) at R={r}: dx vs plain {err['max_abs_err']:.3g} (tol {err['tol']:.3g}); "
          f"launched {totals(counts)}", flush=True)


def reset_peak() -> int:
    """Free what deleted trainers left and start the peak-memory count
    here: -> the bytes allocated now."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def step_ms(trainer, views, reps: int = TIMED_STEPS):
    """Mean time of `reps` steps of the default path (noise drawn from the
    state's generator) by CUDA events after one warm-up step, and the launch
    counts of those steps by (wrapper, shape)."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts

    trainer.run(views)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    start.record()
    for _ in range(reps):
        trainer.state, _ = trainer.step(trainer.state, *views, trainer.emw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, shape_counts()


# phase 4c: the rest of serving. A 5-fold bf16 classifier ensemble over
# phase 3's trunk (each fold its own seeded head, fc_norm and last block),
# POST /predict, NIfTI bodies, resized requests and the int8 engines
FOLDS = 5
# the ensemble's fold-mean probabilities, largest absolute difference: vs
# the same weights with attn_impl="plain" (the kernel's bf16 P moves the
# bf16 features, ENGINE_TOL, and the head and softmax carry that into the
# probabilities; an H100 reads 9.5e-4, the limit is about four times it),
# and vs the mean of the five single-fold engines (the same products, only
# the f32 sum of five softmaxes in another order: an H100 reads 1.5e-8)
CLASSIFY_TOL = {"plain": 4e-3, "folds": 1e-6}
# the int8 engines vs the bf16 ones, the JAX package's own bars: features,
# cosine above INT8_COS for every volume and every volume's nearest
# neighbour kept (tests/test_quant_extract.py); the fold-mean
# probabilities within INT8_PROB_TOL with the same argmax
# (tests/test_serving.py)
INT8_COS, INT8_PROB_TOL = 0.99, 0.05
# resize_trilinear on the card vs its CPU run, largest error over the
# largest magnitude: f32 products summed in another order (TF32 is off)
RESIZE_TOL = 1e-5
RESIZED_SHAPES = ((240, 240, 155), (128, 128, 128))  # a BraTS scan, and an upsample-free cube


def classifier_trees(base: dict, cfg, folds: int) -> list:
    """`folds` classifier trees in the JAX package's ViT layout over phase
    3's MAE encoder weights `base` (patch embed, cls token, blocks) and the
    graft's sincos pos_embed; each fold has its own seeded head (2
    classes), fc_norm and last block, so the fold mean is no one fold's
    answer. The shared leaves are the same arrays in every tree."""
    from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed

    d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    shared = {k: v for k, v in base.items() if k != "norm"}
    shared["pos_embed"] = get_3d_sincos_pos_embed(d, cfg.grid_size, cls_token=True)[None].astype(np.float32)
    trees = []
    for k in range(folds):
        rng = np.random.default_rng(200 + k)
        last = {"norm1": ln(rng, d), "norm2": ln(rng, d),
                "attn": {"qkv": dense(rng, d, 3 * d), "proj": dense(rng, d, d)},
                "mlp": {"Dense_0": dense(rng, d, hidden), "Dense_1": dense(rng, hidden, d)}}
        trees.append({**shared, f"blocks_{cfg.depth - 1}": last, "fc_norm": ln(rng, d), "head": dense(rng, d, 2)})
    return trees


def classify_volumes() -> np.ndarray:
    """Phase 4c's slab: 8 seeded 96^3 volumes, each with its own intensity
    offset and scale, so that their features have nearest neighbours to
    keep (i.i.d. noise volumes sit nearly equidistant)."""
    rng = np.random.default_rng(21)
    i = np.arange(BATCH, dtype=np.float32)[:, None, None, None, None]
    noise = rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32)
    return (1 + 0.25 * i) * noise + 0.5 * (i - 3.5)


def note_launches(rows: list, counts: dict, field: str, path: str) -> None:
    """Each kernel row that `counts` (one path's slab) launched at its shape
    takes the count as `<field>_launches`, and the path's name."""
    for row in rows:
        n = counts.get((row["name"], row["key"]), 0)
        if n:
            row[f"{field}_launches"], row[f"{field}_path"] = n, path


def int8_feature_check(engine, q_engine, vols) -> dict:
    """The int8 FeatureEngine against the bf16 one on `vols`: every
    volume's cosine above INT8_COS and its nearest neighbour kept, 12
    per-head forward launches a slab and nothing else. -> its readings
    and launches."""
    want = engine.infer(vols)
    got, counts = path_launches(q_engine, vols)
    check(got.shape == want.shape and bool(np.isfinite(got).all()), f"int8 features: shape {got.shape}")
    cos = np.sum(got * want, -1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    d_want = np.linalg.norm(want[:, None] - want[None], axis=-1)
    d_got = np.linalg.norm(got[:, None] - got[None], axis=-1)
    order = np.argsort(d_want, -1)
    kept = bool((order[:, 1] == np.argsort(d_got, -1)[:, 1]).all())
    rows = np.arange(len(want))
    margin = float(((d_want[rows, order[:, 2]] - d_want[rows, order[:, 1]]) / d_want[rows, order[:, 1]]).min())
    print(f"int8 features vs bf16: cosine min {cos.min():.6f} (bar {INT8_COS}), nearest neighbour kept {kept} "
          f"(the bf16 features' smallest gap to the second nearest {margin:.3g} of the nearest), "
          f"rel err {rel_err(got, want):.3g}", flush=True)
    check(cos.min() > INT8_COS, f"int8 features: cosine {cos.min():.6f} <= {INT8_COS}")
    check(kept, "int8 features: a nearest neighbour changed")
    check(totals(counts) == {**NO_LAUNCHES, "flash_fwd": 12},
          f"int8 feature slab launched {totals(counts)} (want 12 per-head forward and nothing else)")
    return counts


def int8_case() -> None:
    """Phase 4c's int8 feature check on its own (kernel_mutants.py's
    main-path check for a broken dequantise): phase 3's weights, the bf16
    engine against the int8 one on phase 4c's slab."""
    sys.path.insert(0, str(REPO))
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.serving import FeatureEngine

    tree = mae_encoder_tree(MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH), seed=0)
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH, mae_params=tree)
    int8_feature_check(FeatureEngine(**common), FeatureEngine(quantize="int8", **common), classify_volumes())


def post_predict(port: int, body: bytes):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def predict_phase(ens, tmp: Path) -> dict:
    """POST /predict through a BatchingQueue over the ensemble (built with
    `resize`), counts set to 0 just before the concurrent requests and read
    just after: 12 requests of 1-2 volumes from 4 clients, each answer
    against `ens.infer`; then one `.nii.gz` body against the `.npy` body
    of the same volume, and a 240x240x155 and a 128^3 request resized on
    the card, each against `ens.infer` of the card's resize, which is held
    to its CPU run. -> the run's launches."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.ops import resize_trilinear
    from vit_ae_plus_plus_torch.serving import BatchingQueue, make_http_server
    from vit_ae_plus_plus_torch.utils.nifti import write_nifti

    rng = np.random.default_rng(22)
    sizes = [1, 2] * 6
    requests = [rng.standard_normal((s, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32) for s in sizes]
    want = [ens.infer(r) for r in requests]
    queue = BatchingQueue(ens, max_wait_ms=5.0)
    server = make_http_server(classifier_queue=queue, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    results = [None] * len(requests)

    def client(idxs):
        for i in idxs:
            results[i] = post_predict(port, npy_bytes(requests[i]))

    clients = [threading.Thread(target=client, args=(list(range(c, len(requests), 4)),)) for c in range(4)]
    try:
        reset_launch_counts()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        counts = shape_counts()
        stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=60).read())

        vol = requests[0][0]
        write_nifti(str(tmp / "v.nii.gz"), vol[0])
        nifti = post_predict(port, (tmp / "v.nii.gz").read_bytes())
        npy = post_predict(port, npy_bytes(vol))
        resized = []
        for i, shape in enumerate(RESIZED_SHAPES):
            big = np.random.default_rng(30 + i).standard_normal((1, *shape)).astype(np.float32)
            cpu = resize_trilinear(torch.from_numpy(big[None]), (1, 1, VOLUME, VOLUME, VOLUME))
            card = resize_trilinear(torch.from_numpy(big[None]).cuda(), (1, 1, VOLUME, VOLUME, VOLUME))
            resize_ms = cuda_ms(lambda: resize_trilinear(torch.from_numpy(big[None]).cuda(),
                                                         (1, 1, VOLUME, VOLUME, VOLUME)), reps=3)
            resized.append((shape, rel_err(card.cpu().numpy(), cpu.numpy()), resize_ms,
                            post_predict(port, npy_bytes(big)), ens.infer(card.cpu().numpy())))
    finally:
        server.shutdown()
        queue.close()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "server thread did not stop")
    check(all(r is not None for r in results), "a /predict request got no answer")
    served_err = 0.0
    for i, ((status, out), ref) in enumerate(zip(results, want)):
        probs = np.asarray(out["probs"], np.float32)
        check(status == 200 and out["num_folds"] == FOLDS, f"/predict {i}: status {status}, {out.get('num_folds')}")
        check(probs.shape == (sizes[i], 2) and out["pred"] == probs.argmax(-1).tolist(), f"/predict {i}: {out}")
        served_err = max(served_err, rel_err(probs, ref))
    check(served_err <= SERVED_TOL, f"/predict vs engine.infer rel err {served_err:.3g}")
    slabs = stats["total_batches"]
    check(stats["total_requests"] == sum(sizes), f"/stats counted {stats['total_requests']}")
    check(totals(counts) == {**NO_LAUNCHES, "packed_flash_fwd": 12 * FOLDS * slabs},
          f"{slabs} /predict slabs launched {totals(counts)} (want {12 * FOLDS} packed forward per slab)")
    nifti_err = rel_err(np.asarray(nifti[1]["probs"]), np.asarray(npy[1]["probs"]))
    check(nifti[0] == 200 and nifti_err <= SERVED_TOL, f".nii.gz body vs .npy body: {nifti[0]}, {nifti_err:.3g}")
    print(f"/predict: {len(sizes)} requests of {sum(sizes)} volumes in {slabs} slabs, served vs engine.infer rel "
          f"err {served_err:.3g}, {12 * FOLDS} packed launches a slab; .nii.gz vs .npy body rel err {nifti_err:.3g}",
          flush=True)
    for shape, card_err, resize_ms, (status, out), ref in resized:
        err = rel_err(np.asarray(out["probs"], np.float32), ref)
        print(f"/predict with resize of {shape}: card vs CPU resize_trilinear rel err {card_err:.3g} (tol "
              f"{RESIZE_TOL}), {resize_ms:.2f} ms on the card (CUDA events, with the upload); answer vs "
              f"engine.infer of the resized volume rel err {err:.3g}", flush=True)
        check(card_err <= RESIZE_TOL, f"resize {shape} on the card vs the CPU: rel err {card_err:.3g}")
        check(status == 200 and err <= SERVED_TOL, f"resized request {shape}: status {status}, rel err {err:.3g}")
    return counts


def classify_phase(engine, tree: dict, rows: list, feature_ms: float) -> None:
    """Phase 4c: the 5-fold bf16 ensemble held to plain and to its single
    folds (60 packed launches a slab), /predict over HTTP with NIfTI and
    resized requests, the int8 feature and classify engines held to the
    bf16 ones (12 per-head launches a fold and slab), and each path's
    device ms per slab beside bf16 features (information)."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.serving import ClassifierEngine, FeatureEngine

    t0 = time.perf_counter()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    trees = classifier_trees(tree, cfg, FOLDS)
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH)
    vols = classify_volumes()
    ens = ClassifierEngine(vit_params_list=trees, resize=True, **common)
    check(ens.num_folds == FOLDS, f"{ens.num_folds} folds")
    ens.warmup()
    probs, counts = path_launches(ens, vols)
    check(probs.shape == (BATCH, 2) and bool(np.isfinite(probs).all())
          and float(np.abs(probs.sum(-1) - 1).max()) < 1e-5, f"ensemble probabilities {probs}")
    check(totals(counts) == {**NO_LAUNCHES, "packed_flash_fwd": 12 * FOLDS},
          f"one ensemble slab launched {totals(counts)} (want {12 * FOLDS} packed forward and nothing else)")
    note_launches(rows, counts, "classify", f"ClassifierEngine({FOLDS} folds, bf16).infer, one slab")
    plain = ClassifierEngine(vit_params_list=trees, attn_impl="plain", **common).infer(vols)
    plain_err = float(np.abs(probs - plain).max())
    singles = []
    for t in trees:
        singles.append(ClassifierEngine(vit_params_list=[t], **common).infer(vols))
        gc.collect()
    folds_err = float(np.abs(probs - np.mean(singles, axis=0)).max())
    spread = float(max(np.abs(s - singles[0]).max() for s in singles))
    print(f"classify bf16, {FOLDS} folds: fold-mean probabilities vs attn_impl=plain max abs err {plain_err:.3g} "
          f"(tol {CLASSIFY_TOL['plain']}), vs the mean of the single-fold engines {folds_err:.3g} (tol "
          f"{CLASSIFY_TOL['folds']}); the folds' answers differ by up to {spread:.3g}", flush=True)
    check(plain_err <= CLASSIFY_TOL["plain"], f"ensemble vs plain: {plain_err:.3g}")
    check(folds_err <= CLASSIFY_TOL["folds"], f"ensemble vs single folds: {folds_err:.3g}")
    check(spread > CLASSIFY_TOL["plain"], f"the folds' answers differ by only {spread:.3g}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_classify_") as tmp:
        counts = predict_phase(ens, Path(tmp))
    note_launches(rows, counts, "predict", f"serve: POST /predict through BatchingQueue ({FOLDS} folds)")

    common["mae_params"] = tree
    q_feat = FeatureEngine(quantize="int8", **common)
    counts = int8_feature_check(engine, q_feat, vols)
    note_launches(rows, counts, "int8_features", "FeatureEngine(quantize='int8').infer, one slab")
    del common["mae_params"]
    q_cls = ClassifierEngine(vit_params_list=trees, quantize="int8", **common)
    q_probs, counts = path_launches(q_cls, vols)
    q_err = float(np.abs(q_probs - probs).max())
    same = bool((q_probs.argmax(-1) == probs.argmax(-1)).all())
    print(f"int8 classify vs bf16, {FOLDS} folds: fold-mean probabilities max abs diff {q_err:.3g} (bar "
          f"{INT8_PROB_TOL}), argmax kept {same} (the bf16 probabilities' nearest to 0.5: "
          f"{float(np.abs(probs[:, 0] - 0.5).min()):.3g} away)", flush=True)
    check(q_err < INT8_PROB_TOL and same, f"int8 classify vs bf16: {q_err:.3g}, argmax kept {same}")
    check(totals(counts) == {**NO_LAUNCHES, "flash_fwd": 12 * FOLDS},
          f"int8 classify slab launched {totals(counts)} (want {12 * FOLDS} per-head forward and nothing else)")
    note_launches(rows, counts, "int8_classify", f"ClassifierEngine({FOLDS} folds, quantize='int8').infer, one slab")

    slab = torch.from_numpy(vols).cuda()
    times = {"bf16 features": feature_ms,
             f"bf16 classify ({FOLDS} folds)": cuda_ms(lambda: ens._step(slab), reps=3),
             "int8 features": cuda_ms(lambda: q_feat._step(slab), reps=5),
             f"int8 classify ({FOLDS} folds)": cuda_ms(lambda: q_cls._step(slab), reps=3)}
    print(f"serving device ms per slab of {BATCH} (CUDA events, {card_line()}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items()), flush=True)
    profile_run(lambda: q_feat._step(slab), "int8 feature slab", times["int8 features"])
    print(f"classify phase {time.perf_counter() - t0:.1f}s", flush=True)
    return q_feat, ens


@contextlib.contextmanager
def cold_kernels(counter: dict):
    """A process state as at a fresh start: the kernel build directory an
    empty temporary one and no library loaded; every nvcc run counted in
    `counter["nvcc"]`. Restores the build directory and the loaded
    libraries after."""
    from unittest import mock

    from vit_ae_plus_plus_torch.kernels import _build

    popen = subprocess.Popen

    def counted(cmd, *a, **k):
        if "nvcc" in os.path.basename(str(cmd[0])):
            counter["nvcc"] += 1
        return popen(cmd, *a, **k)

    loaded, files = dict(_build._loaded), dict(_build._files)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_build_") as empty:
        _build._loaded.clear()
        _build._files.clear()
        try:
            with mock.patch.object(_build, "BUILD_DIR", Path(empty)), \
                    mock.patch.object(_build.subprocess, "Popen", counted):
                yield Path(empty)
        finally:
            _build._loaded.clear()
            _build._loaded.update(loaded)
            _build._files.clear()
            _build._files.update(files)


def artifact_phase(engines: dict, vols: np.ndarray, tree: dict, rows: list) -> None:
    """Phase 4d: `save_engine` then `load_engine` for phase 3's bf16 feature
    engine, 4c's int8 feature engine and 5-fold classifier. Each load and
    its first slab run in `cold_kernels` (an empty build directory): no
    nvcc run, the shipped libraries only; the loaded slab equal to the
    built engine's bitwise, with the same launches. Prints each artifact's
    MB, the save seconds, the seconds from the load to the first slab's
    answer, and beside them the seconds of building the bf16 feature
    engine from its weights and warming it with the kernels already built
    (a cold start adds phase 1's nvcc seconds). -> each built engine's
    answers on `vols`, by name (phase 7g's references)."""
    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.serving import FeatureEngine
    from vit_ae_plus_plus_torch.serving_aot import load_engine, save_engine

    t_phase = time.perf_counter()
    answers = {}
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH)
    t0 = time.perf_counter()
    FeatureEngine(mae_params=tree, **common).warmup()
    build_s = time.perf_counter() - t0
    gc.collect()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_engine_") as tmp:
        for name, engine in engines.items():
            want, want_counts = path_launches(engine, vols)
            answers[name] = want
            path = os.path.join(tmp, f"{name}.vitae")
            t0 = time.perf_counter()
            meta = save_engine(engine, path)
            save_s = time.perf_counter() - t0
            counter = {"nvcc": 0}
            with cold_kernels(counter) as empty:
                t0 = time.perf_counter()
                loaded = load_engine(path)
                reset_launch_counts()
                got = loaded.infer(vols)
                first_s = time.perf_counter() - t0
                counts = shape_counts()
                built = sorted(p.name for p in empty.rglob("*.so"))
            mb = os.path.getsize(path) / 2**20
            same = bool(np.array_equal(got, want))
            print(f"artifact {name} ({card_line()}): {mb:.1f} MB ({len(meta['weights'])} tensors, kernels "
                  f"{sorted(meta['kernels'])}), save {save_s:.2f} s; load to first slab's answer {first_s:.2f} s with "
                  f"an empty build directory ({counter['nvcc']} nvcc runs; libraries in it after: {built}); the "
                  f"loaded slab equals the built engine's bitwise: {same}; launches {totals(counts)}", flush=True)
            check(counter["nvcc"] == 0, f"artifact {name}: {counter['nvcc']} nvcc runs while loading")
            check(same, f"artifact {name}: the loaded slab differs from the built engine's by "
                  f"{float(np.abs(got - want).max()):.3g}")
            check(counts == want_counts, f"artifact {name}: the loaded slab launched {counts} (built {want_counts})")
            check(all(n.startswith("lib") for n in built) and len(built) == len(meta["kernels"]) > 0,
                  f"artifact {name}: libraries {built} for {sorted(meta['kernels'])}")
            note_launches(rows, counts, f"artifact_{name}", f"load_engine(the {name} artifact).infer, one slab")
            del loaded
            gc.collect()
    print(f"artifact phase ({card_line()}): the bf16 feature engine built from its weights and warmed in "
          f"{build_s:.2f} s with the kernels already built; {time.perf_counter() - t_phase:.1f}s", flush=True)
    return answers


def fused_vit_phase(engine, vols, engine_feats, rows) -> None:
    """One slab through `feature_step` on VisionTransformer3D(ln_fusion="on")
    with the engine's (grafted) weights: held to the engine's features, and
    24 LayerNorm+Dense forward launches (12 at qkv, 12 at fc1) and 12 packed
    attention launches, counts set to 0 just before and read just after."""
    import dataclasses

    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import VisionTransformer3D
    from vit_ae_plus_plus_torch.train.step import feature_step

    cfg = dataclasses.replace(engine.model.cfg, ln_fusion="on")
    model = VisionTransformer3D(cfg)
    model.load_state_dict(engine.model.state_dict(), strict=True)
    model = model.cuda().eval()
    slab = torch.from_numpy(vols).cuda()
    reset_launch_counts()
    feats = feature_step(model, slab).float().cpu().numpy()
    counts = shape_counts()
    r, c = slab.shape[0] * (cfg.num_patches + 1), cfg.embed_dim
    want = {("packed_flash_fwd", (slab.shape[0], cfg.num_heads, cfg.num_patches + 1, c // cfg.num_heads,
                                  "bfloat16")): cfg.depth,
            **ln_dense_launches([(r, c)], "bfloat16", ways=("fwd",), depths=[cfg.depth])}
    check(counts == want, f"ln_fusion='on' slab launched {counts} (want {want})")
    fill_launches(rows, counts, "feature_step on VisionTransformer3D(ln_fusion='on'), one slab")
    check(feats.shape == engine_feats.shape and bool(np.isfinite(feats).all()), "ln_fusion='on' features")
    err = rel_err(feats, engine_feats)
    on_ms = cuda_ms(lambda: feature_step(model, slab), reps=5)
    auto_ms = cuda_ms(lambda: feature_step(engine.model, slab), reps=5)
    print(f"engine bf16 ln_fusion=on: features vs the engine rel err {err:.3g} (tol {ENGINE_TOL['bfloat16']}); "
          f"launched {totals(counts)}; forward_features on a device slab {on_ms:.2f} ms, "
          f"auto {auto_ms:.2f} ms (CUDA events)", flush=True)
    check(err <= ENGINE_TOL["bfloat16"], f"ln_fusion='on' features vs the engine: rel err {err:.3g}")
    profile_run(lambda: feature_step(model, slab), "ln_fusion=on slab", on_ms)


def group_attention(mesh) -> dict:
    """Phase 7a on one rank: ring and sequence-sharded attention at B=2,
    H=12, N=4,097, d=64, bf16, o and the three gradients against
    `flash_attention` on the same inputs, and the launches of each."""
    import torch

    from vit_ae_plus_plus_torch.kernels import (
        flash_attention, reset_launch_counts, ring_flash_attention, seq_sharded_flash_attention,
    )
    from vit_ae_plus_plus_torch.kernels.flash_attention import _bf16_spacing

    gen = torch.Generator(device="cuda").manual_seed(90)
    q, k, v, do = (torch.randn((2, 12, 4097, 64), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))

    def run(fn):
        leaves = tuple(t.clone().requires_grad_() for t in (q, k, v))
        o = fn(*leaves)
        o.backward(do)
        torch.cuda.synchronize()
        return [o.detach(), *(t.grad for t in leaves)]

    want = run(flash_attention)
    tols = {name: SHARDED_SPACINGS["o" if name == "o" else "grad"] * _bf16_spacing(w.float().abs().max().item())
            for name, w in zip(("o", "dq", "dk", "dv"), want)}
    out = {}
    for impl, fn in (("flash_ring", ring_flash_attention), ("flash_seq", seq_sharded_flash_attention)):
        reset_launch_counts()
        t0 = time.perf_counter()
        got = run(lambda q, k, v: fn(q, k, v, mesh))
        wall = time.perf_counter() - t0
        out[impl] = {"errs": {name: (g.float() - w.float()).abs().max().item()
                              for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)},
                     "finite": all(bool(torch.isfinite(g).all()) for g in got),
                     "tols": tols, "counts": shape_counts(), "wall_s": wall}
    return out


def group_vit(mesh) -> dict:
    """Phase 7b on one rank: ViT-B `forward_features` at 128^3 / patch 8,
    batch 2, bf16, through `FeatureEngine.infer` under `set_mesh`, with
    "flash_ring" and "flash_seq" against "flash" on the same seeded
    weights; the launches of each path's run."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import set_mesh
    from vit_ae_plus_plus_torch.serving import FeatureEngine

    cfg = MODEL_ZOO[MODEL](volume_size=GROUP_VOLUME, patch_size=PATCH)
    tree = mae_encoder_tree(cfg, seed=0)
    vols = np.random.default_rng(6).standard_normal((2, 1, GROUP_VOLUME, GROUP_VOLUME, GROUP_VOLUME))
    common = dict(model_name=MODEL, volume_size=GROUP_VOLUME, patch_size=PATCH, batch_size=2)
    want = FeatureEngine(mae_params=tree, attn_impl="flash", **common).infer(vols)
    out = {}
    for impl in ("flash_ring", "flash_seq"):
        engine = FeatureEngine(mae_params=tree, attn_impl=impl, **common)
        with set_mesh(mesh):
            engine.infer(vols)  # warm
            reset_launch_counts()
            t0 = time.perf_counter()
            feats = engine.infer(vols)
            wall = time.perf_counter() - t0
        out[impl] = {"rel_err": rel_err(feats, want), "ok": feats.shape == want.shape
                     and bool(np.isfinite(feats).all()), "counts": shape_counts(), "infer_ms": 1e3 * wall}
        del engine
    torch.cuda.empty_cache()
    return out


def group_train(mesh, reference: dict) -> dict:
    """Phase 7c on one rank: three bf16 MAE steps at phase 5's size with
    attn_impl="flash_ring" under `set_mesh`, from phase 5's weights, views
    and noise: step-1 errors against `reference` (phase 5's default step),
    the launches of each step, and the parameters' largest difference from
    the group's first rank after the steps; then one f32 step the same way
    against phase 5's f32 step (`reference["float32"]`)."""
    import torch
    import torch.distributed as dist

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import set_mesh

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)

    def run(dtype: str, steps: int, want: dict) -> dict:
        trainer = Trainer(tree, stats, dtype, "flash_ring")
        torch.cuda.reset_peak_memory_stats()
        out = []
        with set_mesh(mesh):
            for i in range(steps):
                t0 = time.perf_counter()
                metrics, counts = trainer.run(views, noise[i])
                torch.cuda.synchronize()
                out.append({"metrics": metrics, "counts": counts, "wall_s": time.perf_counter() - t0})
                if i == 0:
                    errs = step_rel_errs(metrics, want["metrics"], {n: g.cpu() for n, g in trainer.grads().items()},
                                         {n: torch.from_numpy(g) for n, g in want["grads"].items()})
        flat = torch.cat([p.detach().flatten() for p in trainer.model.parameters()]).cpu()
        first = flat.clone()
        dist.broadcast(first, src=mesh.ranks["model"][0], group=mesh.groups["model"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        del trainer
        torch.cuda.empty_cache()
        return {"steps": out, "errs": errs, "params_max_diff": float((flat - first).abs().max()), "peak_gib": peak}

    return {"bfloat16": run("bfloat16", TRAIN_STEPS, reference), "float32": run("float32", 1, reference["float32"])}



# phase 7d: data parallelism on a (4, 1) mesh of phase 7's ranks (and a
# (2, 1) one of its first two, timed), every rank on its rows of a global
# batch of BATCH
DDP_FOLDS = 2  # pretrain_kfold's split; 7d trains and extracts fold 0 only


def ddp_shapes(cfg, ranks: int) -> tuple:
    """The attention shapes (B, H, N, d) of one rank of `ranks` in phase 7d:
    the MAE step's encoder (both views of its rows) and decoder, and the
    classifier's (the fine-tune step, extraction)."""
    enc, dec = train_shapes(cfg)
    b = BATCH // ranks
    return (2 * b, *enc[1:]), (b, *dec[1:]), (b, cfg.num_heads, cfg.num_patches + 1, cfg.embed_dim // cfg.num_heads)


def ddp_cases(cfg) -> list:
    """Phase 2's cases at phase 7d's per-rank shapes: (case, label, shape,
    dtype)."""
    enc, dec, vit = ddp_shapes(cfg, GROUP_RANKS)
    enc2, dec2, _ = ddp_shapes(cfg, 2)
    cases = []
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        for where, shape in (("N433 d64 (encoder, a rank of 4)", enc), ("N1729 d32 (decoder, a rank of 4)", dec)):
            cases += [(kernel_case, f"packed {tag} {where}", shape, dtype),
                      (bwd_case, f"packed bwd {tag} {where}", shape, dtype)]
    cases += [(kernel_case, "packed f32 N1729 d64 (fine-tune, a rank of 4)", vit, "float32"),
              (bwd_case, "packed bwd f32 N1729 d64 (fine-tune, a rank of 4)", vit, "float32"),
              (kernel_case, "packed bf16 N1729 d64 (extraction, a rank of 4)", vit, "bfloat16")]
    for where, shape in (("N433 d64 (encoder, a rank of 2)", enc2), ("N1729 d32 (decoder, a rank of 2)", dec2)):
        cases += [(kernel_case, f"packed bf16 {where}", shape, "bfloat16"),
                  (bwd_case, f"packed bwd bf16 {where}", shape, "bfloat16")]
    # the MoCo step's trunk passes over the 'data' group (phase 7d (e)): at a
    # rank of 4 the fine-tune and extraction rows' shape, and at a rank of 2
    moco2 = (BATCH // 2, *vit[1:])
    cases.append((bwd_case, "packed bwd bf16 N1729 d64 (MoCo, a rank of 4)", vit, "bfloat16"))
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "f32")):
        cases += [(kernel_case, f"packed {tag} N1729 d64 (MoCo, a rank of 2)", moco2, dtype),
                  (bwd_case, f"packed bwd {tag} N1729 d64 (MoCo, a rank of 2)", moco2, dtype)]
    return cases


def ddp_step_launches(cfg, ranks: int, dtype: str) -> dict:
    """The attention launches of one rank's data-parallel MAE step."""
    enc, dec, _ = ddp_shapes(cfg, ranks)
    return {(f"packed_flash_{way}", (*shape, dtype)): depth for way in ("fwd", "bwd")
            for shape, depth in ((enc, cfg.depth), (dec, cfg.decoder_depth))}


def finetune_inputs():
    """Phase 7d's fine-tune batch on the card: seeded volumes of one class
    (see FT_GRAD_NAMES)."""
    import torch

    rng = np.random.default_rng(62)
    batch = torch.from_numpy(rng.standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME), dtype=np.float32)).cuda()
    return batch, torch.ones(BATCH, dtype=torch.int64, device="cuda")


def ddp_configs(split_dir: str) -> tuple:
    """pretrain-kfold's data and training configs as its CLI builds them at
    batch BATCH, bf16, one epoch without warmup, and fold 0 of its split.
    No warmup: its learning rates over three steps of 40 epochs' warmup
    stay below 6e-7 and hardly move the weights; at blr's 3.125e-5 the
    loss falls by a third a step, as phase 5's does."""
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.data.splits import kfold_indices

    data_cfg = DataConfig(name="brats", base_path=split_dir, volume_size=VOLUME, in_channels=1, use_z_score=True)
    train_cfg = TrainConfig(epochs=1, warmup_epochs=0, batch_size=BATCH, seed=42, patch_size=PATCH,
                            compute_dtype="bfloat16")
    folds = kfold_indices(np.load(os.path.join(split_dir, "y_whole_ssl.npy")), DDP_FOLDS)[:1]
    return data_cfg, train_cfg, folds


def stats_errs(got: dict, want: dict) -> dict:
    """Each BatchNorm statistic's largest error over its largest magnitude."""
    return {n: float(np.abs(got[n].numpy() - w).max() / np.abs(w).max()) for n, w in want.items()}


@contextlib.contextmanager
def staged_bytes(counter: dict):
    """Add to `counter["bytes"]` the bytes that the gloo transport copies to
    pinned host memory (`parallel.mesh._to_host`) while this is open, and
    to `counter["calls"]` (when it has that key) the number of copies: one
    a collective."""
    from unittest import mock

    from vit_ae_plus_plus_torch.parallel import mesh as transport

    to_host = transport._to_host

    def counted(ts):
        counter["bytes"] += sum(t.numel() * t.element_size() for t in ts)
        if "calls" in counter:
            counter["calls"] += 1
        return to_host(ts)

    with mock.patch.object(transport, "_to_host", counted):
        yield


def rank_peak_and_diff(model, mesh) -> dict:
    """The parameters' largest difference from the 'data' group's first
    rank's, and this process's peak memory."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().flatten() for p in model.parameters()]).cpu()
    first = flat.clone()
    dist.broadcast(first, src=mesh.ranks["data"][0], group=mesh.groups["data"])
    return {"params_max_diff": float((flat - first).abs().max()),
            "params_sha": hashlib.sha256(flat.float().numpy().tobytes()).hexdigest(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def ddp_control(control):
    """Phase 7d's controls: 'local_keys', the loss on one rank's 'data' axis
    (each rank's queries against its own keys); 'local_moments', BatchNorm
    on this rank's rows alone (the group's sum of its moments left out)."""
    from unittest import mock

    from vit_ae_plus_plus_torch.models import moco, vit

    if control == "local_keys":
        return mock.patch.object(moco, "data_coords", lambda mesh=None: (0, 1))
    if control == "local_moments":
        return mock.patch.object(vit, "psum", lambda t, _mesh, _axis: t)
    return contextlib.nullcontext()


def ddp_mae(mesh, want: dict, dtype: str, steps: int, local_moments: bool = False) -> dict:
    """Phase 7d (a) on one rank: `steps` steps of phase 5's trainer (its
    weights, views and noise) on this rank's rows under `mesh`, step 1's
    errors against `want` (phase 5's one-process step: metrics, GRAD_NAMES
    gradients, BatchNorm statistics), each step's launches, wall time and
    host-staged bytes, the gradient all-reduce alone timed, the parameters'
    largest difference from the group's first rank after the steps, the
    peak memory. `local_moments`: the control, BatchNorm on this rank's
    rows alone (the 'data' group's sum of its moments left out)."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import all_reduce_flat, set_mesh

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    d, b = mesh.coords["data"], BATCH // mesh.size("data")

    def mine(t):
        return t[d * b:(d + 1) * b]

    trainer = Trainer(tree, stats, dtype, "auto")
    torch.cuda.reset_peak_memory_stats()
    out = {"steps": []}
    with set_mesh(mesh), ddp_control("local_moments" if local_moments else None):
        for i in range(steps):
            staged = {"bytes": 0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with staged_bytes(staged):
                metrics, counts = trainer.run([mine(v) for v in views],
                                              torch.cat([mine(noise[i]), mine(noise[i][BATCH:])]))
            torch.cuda.synchronize()
            out["steps"].append({"metrics": metrics, "counts": counts, "wall_s": time.perf_counter() - t0,
                                 "staged_bytes": staged["bytes"]})
            if i == 0:
                errs = step_rel_errs(metrics, want["metrics"], {n: g.cpu() for n, g in trainer.grads().items()},
                                     {n: torch.from_numpy(g) for n, g in want["grads"].items()})
                out["errs"] = {**errs, **stats_errs(trainer.stats(), want["stats"])}
        grads = [p.grad for p in trainer.state.tx.params]
        out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
        out["allreduce_s"] = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_flat(grads, mesh)
            torch.cuda.synchronize()
            out["allreduce_s"].append(time.perf_counter() - t0)
    out.update(rank_peak_and_diff(trainer.model, mesh))
    del trainer
    torch.cuda.empty_cache()
    return out


def ddp_finetune(mesh, pth: str, want: dict) -> dict:
    """Phase 7d (b) on one rank: one f32 fine-tune step with timm's mixup
    from 5d's fold-0 `.pth` on this rank's rows, against `want` (the
    one-process step), and its launches."""
    import torch

    from vit_ae_plus_plus_torch.parallel import set_mesh
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    batch, labels = finetune_inputs()
    d, b = mesh.coords["data"], BATCH // mesh.size("data")
    tuner = FineTuner(load_reference_state_dict(pth), "float32", mixup=True)
    with set_mesh(mesh):
        loss, grads, counts = tuner.run(batch[d * b:(d + 1) * b], labels[d * b:(d + 1) * b])
    errs = step_rel_errs({"loss": loss}, {"loss": want["loss"]}, {n: g.cpu() for n, g in grads.items()},
                         {n: torch.from_numpy(g) for n, g in want["grads"].items()})
    del tuner
    torch.cuda.empty_cache()
    return {"errs": errs, "counts": counts}


def ddp_commands(mesh, paths: dict) -> dict:
    """Phase 7d (c) and (d) on one rank: `pretrain_kfold` (fold 0, one
    epoch, bf16) and `extract_ssl_features` (5d's fold-0 `.pth`, bf16) under
    `mesh`, with the launches and wall time of each; then the control,
    `pretrain_kfold` with the gradients left unaveraged (each rank's own
    update), into `paths["control_work"]`."""
    from unittest import mock

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.parallel import set_mesh
    from vit_ae_plus_plus_torch.pipelines.extract_features import extract_ssl_features
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold
    from vit_ae_plus_plus_torch.train import step

    data_cfg, train_cfg, folds = ddp_configs(paths["split"])
    size = mesh.size("data")
    out = {}
    with set_mesh(mesh):
        reset_launch_counts()
        t0 = time.perf_counter()
        out["results"] = pretrain_kfold(data_cfg, train_cfg, paths["ranks_work"], model_name=MODEL,
                                        n_splits=DDP_FOLDS, folds=folds, n_devices=size, device="cuda")
        out["pretrain"] = {"wall_s": time.perf_counter() - t0, "counts": shape_counts()}
        reset_launch_counts()
        t0 = time.perf_counter()
        extract_ssl_features(data_cfg, paths["pth"], paths["ranks_features"], model_name=MODEL, batch_size=BATCH,
                             patch_size=PATCH, compute_dtype="bfloat16", n_devices=size, device="cuda")
        out["extract"] = {"wall_s": time.perf_counter() - t0, "counts": shape_counts()}
        with mock.patch.object(step, "average_grads", lambda params, shard_axes=None: None):
            pretrain_kfold(data_cfg, train_cfg, paths["control_work"], model_name=MODEL, n_splits=DDP_FOLDS,
                           folds=folds, n_devices=size, device="cuda")
    return out


# phase 7d (e): the MoCo step over the 'data' group, (trunk, dtype, ranks),
# one step each, held to phase 5g's one-process step
MOCO_DDP_RUNS = (("vit", "float32", GROUP_RANKS), ("vit", "bfloat16", GROUP_RANKS), ("vit", "float32", 2),
                 ("vit", "bfloat16", 2), ("resnet", "float32", GROUP_RANKS), ("resnet", "float32", 2))
MOCO_CONTROLS = ("local_keys", "local_moments")


def ddp_moco(mesh, want: dict, arch: str, dtype: str, steps: int, control: str = None) -> dict:
    """Phase 7d (e) on one rank: `steps` MoCo steps of phase 5g's trainer
    (its weights and views) on this rank's rows under `mesh`, step 1's
    readings against `want` (phase 5g's one-process step), each step's
    launches, wall time and host stagings (bytes and count), the gradient
    all-reduce alone timed, the parameters' largest difference from the
    group's first rank after the steps, the peak memory; `control` as
    `ddp_control`."""
    import torch

    from vit_ae_plus_plus_torch.parallel import all_reduce_flat, set_mesh

    d, b = mesh.coords["data"], BATCH // mesh.size("data")
    views = [v[d * b:(d + 1) * b] for v in moco_views()]
    torch.cuda.reset_peak_memory_stats()
    trainer = MoCoTrainer(moco_base_sd(arch), dtype, "auto", arch=arch)
    out = {"steps": []}
    with set_mesh(mesh), ddp_control(control):
        for i in range(steps):
            staged = {"bytes": 0, "calls": 0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with staged_bytes(staged):
                got, counts = trainer.run(*views)
            torch.cuda.synchronize()
            out["steps"].append({"loss": got["loss"], "counts": counts, "wall_s": time.perf_counter() - t0,
                                 "staged_bytes": staged["bytes"], "staged_calls": staged["calls"]})
            if i == 0:
                out["errs"] = moco_errs(on_host(got), want["want"])
        grads = [p.grad for p in trainer.state.tx.params]
        out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
        out["allreduce_s"] = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_flat(grads, mesh)
            torch.cuda.synchronize()
            out["allreduce_s"].append(time.perf_counter() - t0)
    out.update(rank_peak_and_diff(trainer.model, mesh))
    del trainer, grads
    torch.cuda.empty_cache()
    return out


def ddp_contrastive(mesh, want: dict, control: str = None) -> dict:
    """Phase 7d (f) on one rank: one f32 contrastive step of phase 5h's
    trainer on this rank's rows under `mesh`, its readings against `want`
    (phase 5h's one-process f32 step), its launches, wall time and host
    stagings, the parameters' difference from the first rank's, the peak
    memory; `control` as `ddp_control`."""
    import torch

    from vit_ae_plus_plus_torch.parallel import set_mesh

    d, b = mesh.coords["data"], BATCH // mesh.size("data")
    views = [v[d * b:(d + 1) * b] for v in contrastive_views()]
    torch.cuda.reset_peak_memory_stats()
    trainer = ContrastiveTrainer("float32", "auto")
    staged = {"bytes": 0, "calls": 0}
    with set_mesh(mesh), ddp_control(control), staged_bytes(staged):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, counts = trainer.run(*views)
        torch.cuda.synchronize()
    out = {"errs": moco_errs(on_host(got), want), "counts": counts, "wall_s": time.perf_counter() - t0,
           "staged_bytes": staged["bytes"], "staged_calls": staged["calls"]}
    out.update(rank_peak_and_diff(trainer.model, mesh))
    del trainer
    torch.cuda.empty_cache()
    return out


def moco_kfold_ddp_configs(split_dir: str) -> tuple:
    """`moco_kfold`'s data and training configs for phase 7d (e): f32 (bf16
    rounding alone moves the MoCo loss by about 1e-3, phase 5g), batch
    BATCH, 2 epochs, one resume and min-loss write, and one fold: fold 0's
    first 16 training volumes (2 steps an epoch) and its 24 test volumes."""
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.data.splits import kfold_indices

    data_cfg = DataConfig(name="brats", base_path=split_dir, volume_size=VOLUME, in_channels=1, use_z_score=True)
    train_cfg = TrainConfig(epochs=2, batch_size=BATCH, seed=42, patch_size=PATCH, compute_dtype="float32",
                            ckpt_every=2)
    train, test = kfold_indices(np.load(os.path.join(split_dir, "y_whole_ssl.npy")), DDP_FOLDS)[0]
    return data_cfg, train_cfg, [(train[:2 * BATCH], test)]


class Nudged:
    """A dataset whose volumes come out scaled by `scale` (after the
    z-score and the augmentation): the input of the floor run."""

    def __init__(self, dataset, scale: float):
        self.dataset, self.scale = dataset, scale

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        aug, orig, label = self.dataset[item]
        return aug * self.scale, orig * self.scale, label


def run_moco_kfold(paths: dict, work: str, n_devices=None, scale: float = 1.0) -> dict:
    """`moco_kfold` on `moco_kfold_ddp_configs` into `paths[work]`, without
    warmup (its first learning rate would be 0): lr 0.6 x 8 / 256; with
    `scale`, on the volumes scaled by it (`Nudged`)."""
    from unittest import mock

    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    data_cfg, train_cfg, folds = moco_kfold_ddp_configs(paths["split"])
    real = tmk.get_dataset
    nudged = mock.patch.object(tmk, "get_dataset", lambda *a, **kw: Nudged(real(*a, **kw), scale))
    with nudged if scale != 1.0 else contextlib.nullcontext():
        return tmk.moco_kfold(data_cfg, train_cfg, paths[work], n_splits=DDP_FOLDS, folds=folds, warmup_epochs=0,
                              n_devices=n_devices, device="cuda")


def ddp_moco_commands(mesh, paths: dict) -> dict:
    """Phase 7d (e)'s command on one rank: `moco_kfold` under `mesh`, its
    launches and wall time; then the control, the gradients left unaveraged
    (each rank's own LARS update), into `paths["moco_control_work"]`."""
    from unittest import mock

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.parallel import set_mesh
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    size = mesh.size("data")
    with set_mesh(mesh):
        reset_launch_counts()
        t0 = time.perf_counter()
        results = run_moco_kfold(paths, "moco_ranks_work", size)
        out = {"moco_kfold": {"results": results, "wall_s": time.perf_counter() - t0, "counts": shape_counts()}}
        with mock.patch.object(tmk, "average_grads", lambda params, shard_axes=None: None):
            run_moco_kfold(paths, "moco_control_work", size)
    return out


def group_ddp(references: dict, paths: dict) -> dict:
    """Phase 7d on one rank of phase 7's world: the MAE step on the (4, 1)
    mesh in f32 and bf16 and the local-moments control, the bf16 step on a
    (2, 1) mesh of the first two ranks, the fine-tune step and the
    commands on (4, 1); (e) the MoCo step (MOCO_DDP_RUNS), its controls
    and `moco_kfold`; (f) the contrastive step and its control. Every rank
    makes every mesh (make_mesh is collective; a rank outside one gets None
    and skips its runs)."""
    from vit_ae_plus_plus_torch.parallel import barrier, make_mesh

    mesh = make_mesh(GROUP_RANKS, 1)
    with warnings.catch_warnings():  # a mesh of 2 of the 4 ranks warns
        warnings.simplefilter("ignore")
        pair = make_mesh(2, 1)
    reference = references["step"]
    out = {"float32": ddp_mae(mesh, reference["float32"], "float32", DDP_STEPS),
           "bfloat16": ddp_mae(mesh, reference, "bfloat16", DDP_STEPS),
           "control": ddp_mae(mesh, reference["float32"], "float32", 1, local_moments=True)}
    if pair is not None:
        out["pair"] = ddp_mae(pair, reference, "bfloat16", DDP_STEPS)
    out["finetune"] = ddp_finetune(mesh, paths["pth"], references["finetune"])
    out.update(ddp_commands(mesh, paths))
    moco = references["moco"]
    for arch, dtype, ranks in MOCO_DDP_RUNS:
        barrier(mesh)  # the ranks outside a (2, 1) run wait here, not in their next run's step
        on = mesh if ranks == GROUP_RANKS else pair
        if on is not None:
            out[f"moco_{arch}_{dtype}_{ranks}"] = ddp_moco(on, moco[arch][dtype], arch, dtype, 1)
    barrier(mesh)
    for control in MOCO_CONTROLS:
        out[f"moco_{control}"] = ddp_moco(mesh, moco["vit"]["float32"], "vit", "float32", 1, control)
    for control in (None, "local_moments"):
        out[f"contrastive_{control}"] = ddp_contrastive(mesh, references["contrastive"], control)
    out.update(ddp_moco_commands(mesh, paths))
    return out


# phase 7e: the sharded training state on phase 7's ranks (gloo, all on the
# one card: correctness and bytes, no speed). (a) the FSDP MAE step on a
# (4, 1) mesh in f32 and bf16 and (b) the MoCo ViT FSDP step on (4, 1) in
# f32, each rank's resident parameters and optimizer state; (c) the TP MAE
# step on (1, 2) with 'flash' in f32 and bf16; (d) on (2, 2) the TP step and
# the 'flash_ring' step in bf16. Each against phase 5's (or 5g's)
# one-process step within the same limits as phase 7d's data-parallel step
SHARDED_RUNS = (("fsdp", "float32", (GROUP_RANKS, 1), "auto"), ("fsdp", "bfloat16", (GROUP_RANKS, 1), "auto"),
                ("tp", "float32", (1, 2), "flash"), ("tp", "bfloat16", (1, 2), "flash"),
                ("tp", "bfloat16", (2, 2), "flash"), ("ring", "bfloat16", (2, 2), "flash_ring"))


def tp_shapes(cfg, data: int, model: int) -> tuple:
    """(B, H, N, d) of a TP rank's per-head attention in the MAE step: the
    encoder over both views of its data coordinate's rows, the decoder over
    the rows, each with H / M heads."""
    enc, dec = train_shapes(cfg)
    b = BATCH // data
    return (2 * b, enc[1] // model, *enc[2:]), (b, dec[1] // model, *dec[2:])


def sharded_launches(cfg, kind: str, mesh_shape: tuple, dtype: str) -> dict:
    """The attention launches of one rank's step of phase 7e's run."""
    data, model = mesh_shape
    if kind == "fsdp":  # a block's forward runs again in the backward, where it gathers its leaves again
        return {key: 2 * n if key[0].endswith("fwd") else n for key, n in ddp_step_launches(cfg, data, dtype).items()}
    if kind == "tp":
        shapes, names, per = tp_shapes(cfg, data, model), ("flash_fwd", "flash_bwd"), 1
    else:  # the ring: each block's attention in `model` ring steps over its shard of the rows
        from vit_ae_plus_plus_torch.parallel import padded_len

        shapes = [(2 * BATCH // data if i == 0 else BATCH // data, h, padded_len(n, model) // model, d)
                  for i, (_, h, n, d) in enumerate(train_shapes(cfg))]
        names, per = ("ring_flash_fwd", "ring_flash_bwd"), model
    return {(name, (*shape, dtype)): depth * per for name in names
            for shape, depth in zip(shapes, (cfg.depth, cfg.decoder_depth))}


def sharded_cases(cfg) -> list:
    """Phase 2's cases at phase 7e's TP shapes, and phase 6's at its ring
    blocks: (case, label, layout, shape, dtype) and (label, B, H, N, d)."""
    cases = []
    for (data, model), dtypes in (((1, 2), ("bfloat16", "float32")), ((2, 2), ("bfloat16",))):
        enc, dec = tp_shapes(cfg, data, model)
        for dtype in dtypes:
            tag = "bf16" if dtype == "bfloat16" else "f32"
            for where, shape in ((f"N433 d64 H{enc[1]} (encoder, TP rank of ({data}, {model}))", enc),
                                 (f"N1729 d32 H{dec[1]} (decoder, TP rank of ({data}, {model}))", dec)):
                cases += [(kernel_case, f"per-head {tag} {where}", "per_head", shape, dtype),
                          (bwd_case, f"per-head bwd {tag} {where}", "per_head", shape, dtype)]
    enc, dec = train_shapes(cfg)
    rings = [("ring bf16 NB224 d64 (encoder, (2, 2))", BATCH, enc[1], enc[2], 64),
             ("ring bf16 NB872 d32 (decoder, (2, 2))", BATCH // 2, dec[1], dec[2], 32)]
    return cases, rings


def pipe_cases(cfg) -> list:
    """Phase 2's per-head cases at phase 7f's stage microbatches, forward
    and backward, bf16 and f32: (case, label, shape, dtype)."""
    shapes = {pipe_shapes(cfg, data, pipe) for _, (data, pipe), _ in PIPE_RUNS}
    cases = []
    for enc, dec in sorted(shapes):
        for dtype in ("bfloat16", "float32"):
            tag = "bf16" if dtype == "bfloat16" else "f32"
            for where, shape in ((f"B{enc[0]} N433 d64 (encoder, a GPipe microbatch)", enc),
                                 (f"B{dec[0]} N1729 d32 (decoder, a GPipe microbatch)", dec)):
                cases += [(kernel_case, f"per-head {tag} {where}", shape, dtype),
                          (bwd_case, f"per-head bwd {tag} {where}", shape, dtype)]
    return cases


def resident_bytes(params, tx) -> dict:
    """This rank's bytes of parameters and of optimizer state (moments,
    traces, their step counts)."""
    import torch

    state = [t for p in tx.params for t in tx.opt.state[p].values() if torch.is_tensor(t)]
    return {"params": sum(p.numel() * p.element_size() for p in params),
            "optimizer": sum(t.numel() * t.element_size() for t in state)}


def whole_diff(model, mesh) -> float:
    """The whole parameters' largest difference from those of the mesh's
    first rank (every rank gathers: collective)."""
    import torch
    import torch.distributed as dist

    from vit_ae_plus_plus_torch.parallel import fsdp

    whole = fsdp.full_state_dict(model)
    flat = torch.cat([whole[n].float().flatten() for n, _ in model.named_parameters()]).cpu()
    diff = 0.0
    for axis in ("data", "model"):
        if mesh.size(axis) > 1:
            first = flat.clone()
            dist.broadcast(first, src=mesh.ranks[axis][0], group=mesh.groups[axis])
            diff = max(diff, float((flat - first).abs().max()))
    return diff


def sharded_mae(mesh, want: dict, dtype: str, kind: str, attn_impl: str) -> dict:
    """Phase 7e (a), (c), (d) on one rank: one step of phase 5's trainer (its
    weights, views and step-1 noise) on this rank's data coordinate's rows,
    the state sharded by `kind` ('fsdp', 'tp'; 'ring' replicated with
    'flash_ring'), its errors against `want` (phase 5's one-process step:
    the gradients gathered whole), launches, host-staged bytes, resident
    bytes, the whole parameters' difference from the first rank's, peak."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import fsdp, set_mesh, tp

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    d, b = mesh.coords["data"], BATCH // mesh.size("data")

    def mine(t):
        return t[d * b:(d + 1) * b]

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(tree, stats, dtype, attn_impl)
    model = trainer.model
    replicated = resident_bytes(list(model.parameters()), trainer.state.tx)["params"]
    if kind == "fsdp":
        trainer.state, _ = fsdp.shard_train_state_fsdp(trainer.state, mesh)
    elif kind == "tp":
        trainer.state = tp.shard_train_state(trainer.state, mesh)
    out = {}
    with set_mesh(mesh):
        staged = {"bytes": 0}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with staged_bytes(staged):
            metrics, counts = trainer.run([mine(v) for v in views], torch.cat([mine(noise[0]), mine(noise[0][BATCH:])]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        named, placements = dict(model.named_parameters()), getattr(model, "placements", {})
        grads = {n: tp.whole(n, named[n].grad, placements.get(n, {}), mesh).float() for n in trainer.grad_names}
        errs = step_rel_errs(metrics, want["metrics"], {n: g.cpu() for n, g in grads.items()},
                             {n: torch.from_numpy(g) for n, g in want["grads"].items()})
        out.update(errs={**errs, **stats_errs(trainer.stats(), want["stats"])}, counts=counts, wall_s=wall,
                   staged_bytes=staged["bytes"], metrics=metrics, replicated_param_bytes=replicated,
                   resident=resident_bytes(list(model.parameters()), trainer.state.tx),
                   qkv_block=tuple(named["blocks.0.attn.qkv.weight"].shape),
                   placed={n: sorted(dims) for n, dims in placements.items()},
                   params_max_diff=whole_diff(model, mesh))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer, model, named
    torch.cuda.empty_cache()
    return out


def sharded_moco(mesh, want: dict) -> dict:
    """Phase 7e (b) on one rank: one f32 MoCo step of phase 5g's trainer on
    this rank's rows, both encoders and the LARS traces sharded over
    'data', its readings (gathered whole) against `want` (phase 5g's
    one-process step), launches, resident bytes, peak."""
    import torch

    from vit_ae_plus_plus_torch.parallel import fsdp, set_mesh, tp

    d, b = mesh.coords["data"], BATCH // mesh.size("data")
    views = [v[d * b:(d + 1) * b] for v in moco_views()]
    torch.cuda.reset_peak_memory_stats()
    trainer = MoCoTrainer(moco_base_sd("vit"), "float32", "auto")
    mom = trainer.state.momentum_encoder
    replicated = resident_bytes([*trainer.model.parameters(), *mom.parameters()], trainer.state.tx)["params"]
    trainer.state, _ = fsdp.shard_moco_state_fsdp(trainer.state, mesh)
    mom = trainer.state.momentum_encoder
    with set_mesh(mesh):
        got, counts = trainer.run(*views)
        named, placed = dict(trainer.model.named_parameters()), trainer.model.placements
        grads, _, mom_leaves = MOCO_NAMES["vit"]
        got.update({n: tp.whole(n, named[n].grad, placed[n], mesh).float() for n in grads if n in placed})
        mom_named = dict(mom.named_parameters())
        got.update({f"momentum_encoder.{n}": tp.whole(n, mom_named[n].detach(), mom.placements[n], mesh).float()
                    for n in mom_leaves if n in mom.placements})
        out = {"errs": moco_errs(on_host(got), want["want"]), "counts": counts, "loss": got["loss"],
               "replicated_param_bytes": replicated,
               "resident": resident_bytes([*trainer.model.parameters(), *mom.parameters()], trainer.state.tx),
               "params_max_diff": whole_diff(trainer.model, mesh)}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer, mom, named, mom_named
    torch.cuda.empty_cache()
    return out


def group_sharded(references: dict) -> dict:
    """Phase 7e on one rank of phase 7's world (SHARDED_RUNS, then the MoCo
    FSDP step); every rank makes every mesh and waits at a barrier before
    each run (a rank outside a mesh gets None and skips its run)."""
    from vit_ae_plus_plus_torch.parallel import barrier, make_mesh

    with warnings.catch_warnings():  # a mesh of 2 of the 4 ranks warns
        warnings.simplefilter("ignore")
        meshes = {shape: make_mesh(*shape) for shape in sorted({shape for _, _, shape, _ in SHARDED_RUNS})}
    world = meshes[(GROUP_RANKS, 1)]
    reference = references["step"]
    out = {}
    t0 = time.perf_counter()
    for kind, dtype, shape, attn_impl in SHARDED_RUNS:
        barrier(world)
        if meshes[shape] is not None:
            want = reference["float32"] if dtype == "float32" else reference
            out[f"{kind}_{dtype}_{shape}"] = sharded_mae(meshes[shape], want, dtype, kind, attn_impl)
    barrier(world)
    out["moco"] = sharded_moco(world, references["moco"]["vit"]["float32"])
    out["seconds"] = time.perf_counter() - t0
    return out


def check_sharded(results: list, rows: list, refs: dict) -> None:
    """Phase 7e's limits on the ranks' numbers; fills its rows' launches."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    card = card_line()
    mb = lambda n: f"{n / 1e6:.1f} MB"  # noqa: E731
    for kind, dtype, shape, attn_impl in SHARDED_RUNS:
        name = f"{kind}_{dtype}_{shape}"
        tol, want_counts = STEP_TOL[dtype], sharded_launches(cfg, kind, shape, dtype)
        ranks = [(rank, res["sharded"][name]) for rank, res in enumerate(results) if name in res["sharded"]]
        check(len(ranks) == shape[0] * shape[1], f"7e {name} ran on {len(ranks)} ranks")
        for rank, t in ranks:
            res = t["resident"]
            print(f"sharded rank {rank} {kind} {dtype} MAE step on {shape} attn_impl={attn_impl!r} vs phase 5's "
                  f"one-process step, relative errors: " + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
                  + f" (tol loss terms and statistics {tol['loss']}, grads {tol['grad']}); whole parameters' "
                  f"largest difference from the first rank's after the step {t['params_max_diff']:.3g}; qkv block "
                  f"{t['qkv_block']}", flush=True)
            print(f"sharded rank {rank} {kind} {dtype} {shape} ({card}): resident parameters {mb(res['params'])} "
                  f"(replicated: {mb(t['replicated_param_bytes'])}), optimizer state {mb(res['optimizer'])}, "
                  f"together {mb(res['params'] + res['optimizer'])}; peak {t['peak_gib']:.2f} GiB; host-staged "
                  f"{mb(t['staged_bytes'])}; step wall {1e3 * t['wall_s']:.1f} ms (host clock, gloo through "
                  "pinned host memory, information only)", flush=True)
            for k, v in t["errs"].items():
                check(v <= (tol["grad"] if k in GRAD_NAMES else tol["loss"]), f"7e rank {rank} {name} {k}: {v:.3g}")
            check(t["params_max_diff"] == 0.0, f"7e rank {rank} {name}: whole parameters differ from the first "
                  f"rank's by {t['params_max_diff']:.3g}")
            check(t["counts"] == want_counts, f"7e rank {rank} {name} launched {t['counts']} (want {want_counts})")
            if kind == "tp":
                check(t["qkv_block"] == (3 * cfg.embed_dim // shape[1], cfg.embed_dim),
                      f"7e rank {rank} {name}: qkv block {t['qkv_block']}")
            if kind == "fsdp":
                check(res["params"] < 0.3 * t["replicated_param_bytes"],
                      f"7e rank {rank} {name}: {mb(res['params'])} of parameters resident, replicated "
                      f"{mb(t['replicated_param_bytes'])}")
        counts = ranks[0][1]["counts"]
        unrowed = sorted(k for k in counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"7e {name} launched kernels at shapes that no row holds against plain: {unrowed}")
        fill_launches(rows, counts, f"make_train_step, compute_dtype='{dtype}', attn_impl='{attn_impl}', {kind} on a "
                      f"{shape} mesh, one step, rank 0")
    ref = refs["moco"]["vit"]["float32"]
    # the base encoder's passes run their forward again in the backward (FSDP's re-gather)
    limits, want_counts = ref["limits"], moco_step_launches("float32", BATCH // GROUP_RANKS)
    want_counts = {key: n + 24 if key[0].endswith("fwd") else n for key, n in want_counts.items()}
    for rank, res in enumerate(results):
        t = res["sharded"]["moco"]
        r = t["resident"]
        print(f"sharded rank {rank} MoCo-ViT f32 FSDP step on ({GROUP_RANKS}, 1) vs phase 5g's one-process step: "
              + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
              + " (limits " + ", ".join(f"{k} {v:.3g}" for k, v in limits.items()) + f"); loss {t['loss']:.6f}; "
              f"both encoders' parameters {mb(r['params'])} (replicated: {mb(t['replicated_param_bytes'])}), LARS "
              f"traces {mb(r['optimizer'])}; peak {t['peak_gib']:.2f} GiB ({card})", flush=True)
        bad = {k: v for k, v in t["errs"].items() if v > limits[k]}
        check(not bad, f"7e rank {rank} MoCo FSDP step: {bad}")
        check(t["params_max_diff"] == 0.0, f"7e rank {rank} MoCo FSDP: whole parameters differ by "
              f"{t['params_max_diff']:.3g}")
        check(t["counts"] == want_counts, f"7e rank {rank} MoCo FSDP launched {t['counts']}")
        check(r["params"] < 0.3 * t["replicated_param_bytes"], f"7e rank {rank} MoCo FSDP: {mb(r['params'])} resident")
    print(f"phase 7e (the sharded training state): {max(res['sharded']['seconds'] for res in results):.1f}s on the "
          "slowest rank", flush=True)


# phase 7f: the GPipe pipeline on phase 7's ranks (gloo, all on the one
# card: correctness, bytes and launches, no speed). (a) the MAE step on a
# (1, 4) pipeline mesh in f32 and bf16 and (b) on (2, 2) with FSDP composed
# in f32, each against phase 5's one-process step, the leaves outside the
# stacks bitwise equal on every rank; (c) `pretrain_kfold` with
# pipe_devices=2 on (2, 2), its `.pth` loaded into the one-process model,
# and a resume with pipe_devices=4 refused
PIPE_RUNS = (("float32", (1, GROUP_RANKS), False), ("bfloat16", (1, GROUP_RANKS), False),
             ("float32", (2, 2), True))


def pipe_microbatches(data: int, pipe: int) -> int:
    """The microbatches `pretrain_kfold` takes on a (data, pipe) mesh."""
    from vit_ae_plus_plus_torch.parallel import auto_microbatches

    return auto_microbatches(BATCH, pipe, data=data)


def pipe_shapes(cfg, data: int, pipe: int) -> tuple:
    """(B, H, N, d) of a stage's attention: one microbatch of the encoder's
    rows (both views) and of the decoder's."""
    enc, dec = train_shapes(cfg)
    rows = BATCH // data // pipe_microbatches(data, pipe)
    return (rows, *enc[1:]), (rows, *dec[1:])


def pipe_launches(cfg, mesh_shape: tuple, dtype: str, fsdp: bool) -> dict:
    """The per-head launches ('flash_local') of one stage's step: each of
    its L / S blocks once a microbatch (2M encoder microbatches, M decoder
    ones), the forward twice under FSDP (the block recomputed in the
    backward, where it gathers its leaves again)."""
    data, pipe = mesh_shape
    m = pipe_microbatches(data, pipe)
    out = {}
    for shape, depth, mbs in zip(pipe_shapes(cfg, data, pipe), (cfg.depth, cfg.decoder_depth), (2 * m, m)):
        n = depth // pipe * mbs
        out[("flash_fwd", (*shape, dtype))] = 2 * n if fsdp else n
        out[("flash_bwd", (*shape, dtype))] = n
    return out


def shared_diff(model, mesh) -> float:
    """The largest difference of the leaves outside the block stacks from
    the mesh's first rank's (collective over 'pipe' and 'data')."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().float().flatten() for n, p in model.named_parameters()
                      if not n.startswith(("blocks.", "decoder_blocks."))]).cpu()
    diff = 0.0
    for axis in ("pipe", "data"):
        if mesh.size(axis) > 1:
            first = flat.clone()
            dist.broadcast(first, src=mesh.ranks[axis][0], group=mesh.groups[axis])
            diff = max(diff, float((flat - first).abs().max()))
    return diff


def pipe_mae(mesh, want: dict, dtype: str, fsdp: bool) -> dict:
    """Phase 7f (a), (b) on one rank: one step of phase 5's trainer (its
    weights, views and step-1 noise) on this rank's data coordinate's rows,
    the state in the stage layout (`shard_pipeline_state`, FSDP composed
    with `fsdp`), the MAE forward pipelined (`pipelined_mae_forward`) ->
    its errors against `want` on the `GRAD_NAMES` it holds, launches,
    host-staged bytes, resident bytes, the shared leaves' difference from
    the first rank's, peak."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import pp, set_mesh, tp
    from vit_ae_plus_plus_torch.train import make_train_step

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    d, b = mesh.coords["data"], BATCH // mesh.size("data")

    def mine(t):
        return t[d * b:(d + 1) * b]

    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(tree, stats, dtype, "auto")
    model = trainer.model
    replicated = resident_bytes(list(model.parameters()), trainer.state.tx)["params"]
    trainer.state, _ = pp.shard_pipeline_state(trainer.state, mesh, "data" if fsdp else None)
    gc.collect()
    torch.cuda.empty_cache()
    m = pipe_microbatches(mesh.size("data"), mesh.size("pipe"))
    rows_noise = torch.cat([mine(noise[0]), mine(noise[0][BATCH:])])
    step = make_train_step(model, PATCH, forward_fn=lambda mm, a, c, _g: pp.pipelined_mae_forward(
        mm, a, c, mesh=mesh, n_microbatches=m, noise=rows_noise), **trainer.kw)
    with set_mesh(mesh):
        staged = {"bytes": 0}
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with staged_bytes(staged):
            trainer.state, metrics = step(trainer.state, mine(views[0]), mine(views[1]), trainer.emw)
            metrics = {k: float(v) for k, v in metrics.items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = shape_counts()
        check(all(np.isfinite(v) for v in metrics.values()), f"7f non-finite metrics {metrics}")
        named, placements = dict(model.named_parameters()), model.placements
        grads = {n: tp.whole(n, named[n].grad, placements.get(n, {}), mesh).float().cpu()
                 for n in GRAD_NAMES if n in named}
        errs = step_rel_errs(metrics, want["metrics"], grads, {n: torch.from_numpy(want["grads"][n]) for n in grads})
        out = {"errs": {**errs, **stats_errs(trainer.stats(), want["stats"])}, "counts": counts, "wall_s": wall,
               "staged_bytes": staged["bytes"], "metrics": metrics, "replicated_param_bytes": replicated,
               "resident": resident_bytes(list(model.parameters()), trainer.state.tx), "microbatches": m,
               "grad_names": sorted(grads), "shared_diff": shared_diff(model, mesh),
               "coords": (mesh.coords["data"], mesh.coords["pipe"])}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del trainer, model, named, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipe_pretrain(mesh, refusal_mesh, paths: dict) -> dict:
    """Phase 7f (c) on one rank: `pretrain_kfold` with pipe_devices=2 under
    the (2, 2) `mesh` (fold 0, 2 steps of BATCH, bf16, resume files), the
    first rank loading its `.pth` into the one-process model; then, fold
    0's features set aside, a resume with pipe_devices=4 under the (1, 4)
    `refusal_mesh` -> results, launches, the refusal's message."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
    from vit_ae_plus_plus_torch.parallel import is_writer, mesh_barrier, set_mesh
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    data_cfg, train_cfg, folds = ddp_configs(paths["split"])
    (train_ids, test_ids), = folds
    folds = [(train_ids[:2 * BATCH], test_ids)]
    work = paths["pipe_work"]
    out = {}
    with set_mesh(mesh):
        reset_launch_counts()
        t0 = time.perf_counter()
        out["results"] = pretrain_kfold(data_cfg, dataclasses.replace(train_cfg, pipe_devices=2, resume=True),
                                        work, model_name=MODEL, n_splits=DDP_FOLDS, folds=folds,
                                        n_devices=GROUP_RANKS, device="cuda")
        out["wall_s"], out["counts"] = time.perf_counter() - t0, shape_counts()
        if is_writer(mesh):
            sd = load_reference_state_dict(os.path.join(work, "checkpoints", "fold_0", "checkpoint-min_loss.pth"))
            model = build_model(MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH))
            model.load_state_dict(sd, strict=True)
            out["loaded"] = len(sd)
            with open(os.path.join(work, "checkpoints", "fold_0", "resume", "layout.json")) as f:
                out["layout"] = json.load(f)
            out["resume_files"] = sorted(os.listdir(os.path.join(work, "checkpoints", "fold_0", "resume")))
            feat_dir = os.path.join(work, "ssl_features_dir")
            os.replace(feat_dir, feat_dir + ".first")
            del model, sd
        mesh_barrier(mesh)
    try:
        with set_mesh(refusal_mesh):
            pretrain_kfold(data_cfg, dataclasses.replace(train_cfg, pipe_devices=GROUP_RANKS, resume=True), work,
                           model_name=MODEL, n_splits=DDP_FOLDS, folds=folds, n_devices=GROUP_RANKS, device="cuda")
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def group_pipe(references: dict, paths: dict) -> dict:
    """Phase 7f on one rank of phase 7's world (PIPE_RUNS, then the
    command); every rank makes both pipeline meshes and waits at a barrier
    before each run."""
    from vit_ae_plus_plus_torch.parallel import barrier, make_pipeline_mesh

    meshes = {shape: make_pipeline_mesh(shape[1], shape[0]) for shape in sorted({s for _, s, _ in PIPE_RUNS})}
    line = meshes[(1, GROUP_RANKS)]
    reference = references["step"]
    out = {}
    t0 = time.perf_counter()
    for dtype, shape, fsdp in PIPE_RUNS:
        barrier(line, "pipe")
        want = reference["float32"] if dtype == "float32" else reference
        out[f"{dtype}_{shape}"] = pipe_mae(meshes[shape], want, dtype, fsdp)
    barrier(line, "pipe")
    out["pretrain"] = pipe_pretrain(meshes[(2, 2)], line, paths)
    out["seconds"] = time.perf_counter() - t0
    return out


def check_pipe(results: list, rows: list) -> None:
    """Phase 7f's limits on the ranks' numbers; fills its rows' launches."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    card = card_line()
    mb = lambda n: f"{n / 1e6:.1f} MB"  # noqa: E731
    for dtype, shape, fsdp in PIPE_RUNS:
        name = f"{dtype}_{shape}"
        tol, want_counts = STEP_TOL[dtype], pipe_launches(cfg, shape, dtype, fsdp)
        held = set()
        for rank, res in enumerate(results):
            t = res["pipe"][name]
            r = t["resident"]
            print(f"pipe rank {rank} at {t['coords']} {dtype} MAE step on a (data, pipe) = {shape} mesh"
                  f"{' with FSDP' if fsdp else ''}, {t['microbatches']} microbatches, vs phase 5's one-process "
                  f"step, relative errors: " + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
                  + f" (tol loss terms and statistics {tol['loss']}, grads {tol['grad']}); the leaves outside the "
                  f"stacks' largest difference from the first rank's {t['shared_diff']:.3g}", flush=True)
            print(f"pipe rank {rank} {dtype} {shape} ({card}): resident parameters {mb(r['params'])} (replicated: "
                  f"{mb(t['replicated_param_bytes'])}), optimizer state {mb(r['optimizer'])}; peak "
                  f"{t['peak_gib']:.2f} GiB; host-staged {mb(t['staged_bytes'])} a step; launched {t['counts']} "
                  f"(predicted {want_counts}); step wall {1e3 * t['wall_s']:.1f} ms (host clock, gloo through "
                  "pinned host memory, information only)", flush=True)
            for k, v in t["errs"].items():
                check(v <= (tol["grad"] if k in GRAD_NAMES else tol["loss"]), f"7f rank {rank} {name} {k}: {v:.3g}")
            check(t["shared_diff"] == 0.0, f"7f rank {rank} {name}: the leaves outside the stacks differ from the "
                  f"first rank's by {t['shared_diff']:.3g}")
            check(t["counts"] == want_counts, f"7f rank {rank} {name} launched {t['counts']} (want {want_counts})")
            check("patch_embed.proj.weight" in t["grad_names"], f"7f rank {rank} {name}: no patch embed gradient")
            check(r["params"] < 0.4 * t["replicated_param_bytes"], f"7f rank {rank} {name}: {mb(r['params'])} of "
                  f"parameters resident, replicated {mb(t['replicated_param_bytes'])}")
            held.update(t["grad_names"])
        check(held == set(GRAD_NAMES), f"7f {name}: gradients held to phase 5's {sorted(held)}")
        counts = results[0]["pipe"][name]["counts"]
        unrowed = sorted(k for k in counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"7f {name} launched kernels at shapes that no row holds against plain: {unrowed}")
        fill_launches(rows, counts, f"make_pp_train_step's pipelined forward (attn_impl 'flash_local'), "
                      f"compute_dtype='{dtype}', {'FSDP composed, ' if fsdp else ''}on a (data, pipe) = {shape} "
                      "mesh, one step, rank 0")
    first = results[0]["pipe"]["pretrain"]
    print(f"pipe pretrain_kfold pipe_devices=2 on (2, 2): {first['results']}; {first['wall_s']:.1f} s (host clock, "
          f"information only); .pth of {first.get('loaded')} tensors loaded into the one-process model; resume "
          f"files {first.get('resume_files')}, layout {first.get('layout')}; the resume with pipe_devices="
          f"{GROUP_RANKS} refused: {first['refusal']!r}", flush=True)
    check(all(np.isfinite(r["min_loss"]) for r in first["results"].values()), "7f pretrain_kfold: a loss")
    check(first.get("loaded") and first.get("layout") == {"pipe": 2}
          and first.get("resume_files") == ["checkpoint-stage0.pth", "checkpoint-stage1.pth", "layout.json"],
          f"7f pretrain_kfold: {first.get('loaded')}, {first.get('layout')}, {first.get('resume_files')}")
    for rank, res in enumerate(results):
        t = res["pipe"]["pretrain"]
        check(t["results"] == first["results"], f"7f rank {rank} pretrain_kfold results {t['results']}")
        check(t["refusal"] is not None and f"this run uses --pipe-devices {GROUP_RANKS}" in t["refusal"],
              f"7f rank {rank}: the resume with another pipe_devices was not refused ({t['refusal']!r})")
    print(f"phase 7f (the GPipe pipeline): {max(res['pipe']['seconds'] for res in results):.1f}s on the slowest "
          f"rank ({card})", flush=True)


# phase 7g: the serving mesh on phase 7's ranks (gloo, all on the one card:
# correctness, launches and staged bytes; no speed-up is possible on one
# card). The bf16 and int8 feature engines and the 5-fold classifier on a
# (4, 1) mesh, each slab of BATCH volumes split into BATCH / 4 rows a rank
SERVING_MESH_RUNS = ("features", "int8", "classify")
SERVING_MESH_REPS = 3  # timed slabs after the checked one


def mesh_engine(name: str, mesh):
    """Phase 4c's engine `name` (phase 3's weights; the classifier's folds
    over them) on the serving mesh `mesh`."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.serving import ClassifierEngine, FeatureEngine

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree = mae_encoder_tree(cfg, seed=0)
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH, mesh=mesh)
    if name == "classify":
        return ClassifierEngine(vit_params_list=classifier_trees(tree, cfg, FOLDS), **common)
    return FeatureEngine(mae_params=tree, quantize="int8" if name == "int8" else "none", **common)


def group_serving() -> dict:
    """Phase 7g on one rank: each of SERVING_MESH_RUNS on a (4, 1) serving
    mesh. Rank 0 answers phase 4c's slab (`classify_volumes`) with the
    counts set to 0 just before and read just after, then SERVING_MESH_REPS
    more slabs, and stops the others after each; the others follow. Each
    rank's device ms per slab of its rows (CUDA events around the step),
    its host stagings through `_to_host` (the outputs' gather, the
    messages) and the rows it received from rank 0's host buffer."""
    import torch

    from vit_ae_plus_plus_torch.kernels import reset_launch_counts
    from vit_ae_plus_plus_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(GROUP_RANKS, 1)
    first = mesh.coords["data"] == 0
    vols = classify_volumes()
    out = {}
    for name in SERVING_MESH_RUNS:
        engine = mesh_engine(name, mesh)
        step, ms = engine._step, []

        def timed(batch, step=step, ms=ms):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = step(batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            return res

        engine._step = timed
        staged = {"bytes": 0, "calls": 0}
        res = {}
        with staged_bytes(staged):
            reset_launch_counts()
            if first:
                res["answers"] = engine.infer(vols)
                engine.stop_followers()
            else:
                res["slabs"] = engine.follow()
            res["counts"] = shape_counts()
            res["staged_bytes"], res["staged_calls"] = staged["bytes"], staged["calls"]
            if first:
                for _ in range(SERVING_MESH_REPS):
                    engine.infer(vols)
                engine.stop_followers()
            else:
                res["slabs"] += engine.follow()
        res["rows"] = vols[:BATCH // GROUP_RANKS].nbytes
        res["ms"] = ms
        out[name] = res
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def group_mesh_steps(references: dict) -> dict:
    """Phase 7h on one rank: on a (2, 2) mesh, one f32 step each of
    MoCo-ViT and MoCo-ResNet (phase 5g's weights and views, `ddp_moco`)
    and of the contrastive model (5h's, `ddp_contrastive`) on the rows of
    this rank's data coordinate."""
    from vit_ae_plus_plus_torch.parallel import barrier, make_mesh

    t_phase = time.perf_counter()
    mesh = make_mesh(2, 2)
    out = {}
    for arch in ("vit", "resnet"):
        barrier(mesh, "model")
        barrier(mesh, "data")
        out[f"moco_{arch}"] = ddp_moco(mesh, references["moco"][arch]["float32"], arch, "float32", 1)
    out["contrastive"] = ddp_contrastive(mesh, references["contrastive"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


def check_serving_mesh(results: list, rows: list, refs: dict) -> None:
    """Phase 7g's limits: rank 0's answers against phase 4c's one-process
    engines (ENGINE_TOL in bf16 for the features and the int8 features,
    CLASSIFY_TOL["plain"] for the probabilities), every rank's launches of
    one slab of its rows, every follower's slabs."""
    card = card_line()
    b = BATCH // GROUP_RANKS
    key = (b, 12, (VOLUME // PATCH) ** 3 + 1, 64, "bfloat16")
    want_counts = {"features": {("packed_flash_fwd", key): 12}, "int8": {("flash_fwd", key): 12},
                   "classify": {("packed_flash_fwd", key): 12 * FOLDS}}
    for name in SERVING_MESH_RUNS:
        got, want = results[0]["serving"][name]["answers"], refs["serving"][name]
        if name == "classify":
            err, tol = float(np.abs(got - want).max()), CLASSIFY_TOL["plain"]
        else:
            err, tol = rel_err(got, want), ENGINE_TOL["bfloat16"]
        check(got.shape == want.shape and bool(np.isfinite(got).all()), f"7g {name}: answers {got.shape}")
        print(f"7g serving mesh ({GROUP_RANKS}, 1) {name}: rank 0's answers to phase 4c's slab vs the one-process "
              f"engine's {err:.3g} (tol {tol}); {card}, information only: device ms per slab of {b} rows by rank "
              + "; ".join(f"{r}: " + ", ".join(f"{x:.2f}" for x in res["serving"][name]["ms"])
                          for r, res in enumerate(results))
              + "; host stagings of the checked slab by rank "
              + ", ".join(f"{res['serving'][name]['staged_calls']} of {res['serving'][name]['staged_bytes'] / 1e3:.1f} kB"
                          for res in results)
              + f" (besides {b} volumes of {results[0]['serving'][name]['rows'] / 1e6:.1f} MB scattered from rank 0's "
              f"host slab to each other rank)", flush=True)
        check(err <= tol, f"7g {name}: the mesh engine's answers vs one process's: {err:.3g}")
        for rank, res in enumerate(results):
            r = res["serving"][name]
            check(r["counts"] == want_counts[name], f"7g rank {rank} {name}: one slab launched {r['counts']} "
                  f"(want {want_counts[name]})")
            if rank:
                check(r["slabs"] == 1 + SERVING_MESH_REPS, f"7g rank {rank} {name}: followed {r['slabs']} slabs")
        counts = results[0]["serving"][name]["counts"]
        unrowed = sorted(k for k in counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"7g {name} launched kernels at shapes that no row holds against plain: {unrowed}")
        fill_launches(rows, counts, f"the {name} engine on a ({GROUP_RANKS}, 1) serving mesh, one slab, rank 0")
        note_launches(rows, counts, f"serving_mesh_{name}", f"the {name} engine on a ({GROUP_RANKS}, 1) serving "
                      "mesh, one slab, rank 0")
    print(f"7g serving mesh phase: " + ", ".join(f"rank {r} {res['serving']['seconds']:.1f} s"
                                                  for r, res in enumerate(results)) + f" ({card})", flush=True)


def check_mesh_steps(results: list, rows: list, refs: dict) -> None:
    """Phase 7h's limits: each rank's f32 MoCo (both trunks) and contrastive
    step on (2, 2) against phases 5g's and 5h's one-process steps within
    those phases' f32 gates, the parameters after the step equal on all 4
    ranks (one digest), and the launches of the rows of a data
    coordinate."""
    card = card_line()

    def line(errs: dict) -> str:
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    runs = {"moco_vit": (refs["moco"]["vit"]["float32"]["limits"], moco_step_launches("float32", BATCH // 2)),
            "moco_resnet": (refs["moco"]["resnet"]["float32"].get("limits"), {}),
            "contrastive": (None, contrastive_launches("float32", BATCH // 2))}
    tol = STEP_TOL["float32"]
    for name, (limits, want_counts) in runs.items():
        shas = set()
        for rank, res in enumerate(results):
            t = res["mesh_steps"][name]
            counts = t["steps"][0]["counts"] if "steps" in t else t["counts"]
            if name == "contrastive":
                bad = {k: v for k, v in t["errs"].items() if v > (tol["loss"] if k == "loss" else tol["grad"])}
            else:
                bad = {k: v for k, v in t["errs"].items() if limits and v > limits[k]}
            print(f"7h rank {rank} (d, m) = ({rank // 2}, {rank % 2}) {name} f32 step on (2, 2) vs the one-process "
                  f"step: {line(t['errs'])}; parameters' digest {t['params_sha'][:12]}; {card}, information only: "
                  f"peak {t['peak_gib']:.2f} GiB", flush=True)
            check(limits is not None or name == "contrastive", f"7h {name}: phase 5g has no f32 limits")
            check(not bad, f"7h rank {rank} {name} step on (2, 2): {bad}")
            check(counts == want_counts, f"7h rank {rank} {name}: launched {counts} (want {want_counts})")
            shas.add(t["params_sha"])
        check(len(shas) == 1, f"7h {name}: the parameters after the step differ across the 4 ranks")
        counts = results[0]["mesh_steps"][name]
        counts = counts["steps"][0]["counts"] if "steps" in counts else counts["counts"]
        unrowed = sorted(k for k in counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"7h {name} launched kernels at shapes that no row holds against plain: {unrowed}")
        fill_launches(rows, counts, f"the f32 {name} step on a (2, 2) mesh, rank 0")
    print(f"7h (D, M > 1) steps phase: " + ", ".join(f"rank {r} {res['mesh_steps']['seconds']:.1f} s"
                                                      for r, res in enumerate(results)) + f" ({card})", flush=True)


def rank_mesh():
    """A rank of phase 7: the one card, f32 kept f32, and the (1, 4) mesh."""
    import torch

    from vit_ae_plus_plus_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return make_mesh(1, GROUP_RANKS)


def group_rank(rank: int, references: dict, paths: dict) -> dict:
    """Phase 7: one rank's program in the 4-rank gloo world, all ranks on
    the one card (the kernels were built by the parent). -> its numbers."""
    mesh = rank_mesh()
    return {"attention": group_attention(mesh), "vit": group_vit(mesh),
            "train": group_train(mesh, references["step"]), "ddp": group_ddp(references, paths),
            "sharded": group_sharded(references), "pipe": group_pipe(references, paths),
            "serving": group_serving(), "mesh_steps": group_mesh_steps(references)}


def attention_rank(rank: int) -> dict:
    """Phase 7a alone on one rank (a schedule mutant's check)."""
    return {"attention": group_attention(rank_mesh())}


def run_group(fn, *args) -> list:
    """`fn(rank, *args)` on 4 spawned ranks of one gloo group; -> their results."""
    from vit_ae_plus_plus_torch.parallel import run_ranks

    t0 = time.perf_counter()
    results = run_ranks(fn, GROUP_RANKS, args, timeout=GROUP_TIMEOUT,
                        store_dir=str(REPO / "vit_ae_plus_plus_torch" / "build" / "stores"))
    print(f"group of {GROUP_RANKS} ranks: {time.perf_counter() - t0:.1f}s, spawn and joins included", flush=True)
    return results


def group_key() -> tuple:
    """The launch-count key of one rank's rows at B2 H12 N4097 d64 bf16 over
    4 ranks: 1,032, both the ring's block and the sequence shard."""
    from vit_ae_plus_plus_torch.parallel import padded_len

    return (2, 12, padded_len(4097, GROUP_RANKS) // GROUP_RANKS, 64, "bfloat16")


def check_group_attention(results: list) -> None:
    """Phase 7a's limits: every rank's ring and sequence-sharded attention
    at N4097 against `flash_attention`, and the launches of each."""
    key = group_key()  # one ring block a step, 4 steps; one shard
    want_counts = {"flash_ring": {("ring_flash_fwd", key): GROUP_RANKS, ("ring_flash_bwd", key): GROUP_RANKS},
                   "flash_seq": {("flash_fwd", key): 1, ("flash_bwd", key): 1}}
    for impl in ("flash_ring", "flash_seq"):
        for rank, res in enumerate(results):
            a = res["attention"][impl]
            print(f"group rank {rank} {impl} attention B2 H12 N4097 d64 vs flash_attention: "
                  + ", ".join(f"{k} {v:.3g} (tol {a['tols'][k]:.3g})" for k, v in a["errs"].items())
                  + f"; launched {a['counts']}; {a['wall_s']:.2f} s (host clock, information only)", flush=True)
            check(a["finite"] and all(a["errs"][k] <= a["tols"][k] for k in a["errs"]),
                  f"rank {rank} {impl} attention: {a['errs']} (tols {a['tols']})")
            check(a["counts"] == want_counts[impl], f"rank {rank} {impl} attention launched {a['counts']}")


def ddp_references(reference: dict, paths: dict, moco: dict, contrastive: dict) -> dict:
    """Phase 7d's one-process references, taken here before the ranks
    start: phase 5's step (`reference`), the f32 fine-tune step with mixup
    on the whole batch, `pretrain_kfold` (fold 0, one epoch, bf16) into
    `paths["one_work"]`, the host time of three bf16 steps of phase 5's
    trainer on the whole batch; phase 5g's MoCo steps (`moco`) and 5h's
    contrastive step (`contrastive`), and `moco_kfold` into
    `paths["moco_one_work"]`."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold
    from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

    tuner = FineTuner(load_reference_state_dict(paths["pth"]), "float32", mixup=True)
    loss, grads, _ = tuner.run(*finetune_inputs())
    del tuner
    data_cfg, train_cfg, folds = ddp_configs(paths["split"])
    t0 = time.perf_counter()
    # at the ranks' rate: on D ranks the learning rate counts the global
    # batch D times (the JAX package's eff_batch), so one process takes D
    # times the base rate
    pretrain_kfold(data_cfg, dataclasses.replace(train_cfg, blr=GROUP_RANKS * train_cfg.blr), paths["one_work"],
                   model_name=MODEL, n_splits=DDP_FOLDS, folds=folds, device="cuda")
    pretrain_s = time.perf_counter() - t0
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    views, noise = train_inputs(cfg)
    trainer = Trainer(*mae_tree(cfg, seed=0), "bfloat16", "auto")
    walls = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run(views, noise[i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run_moco_kfold(paths, "moco_one_work")
    moco_kfold_s = time.perf_counter() - t0
    run_moco_kfold(paths, "moco_nudged_work", scale=1 + 2**-20)
    gc.collect()
    torch.cuda.empty_cache()
    return {"step": reference, "finetune": {"loss": loss, "grads": {n: g.cpu().numpy() for n, g in grads.items()}},
            "pretrain_s": pretrain_s, "one_process_walls": walls, "moco": moco, "contrastive": contrastive,
            "moco_kfold_s": moco_kfold_s}


def files_under(root: str) -> list:
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def check_ddp(results: list, rows: list, refs: dict, paths: dict) -> None:
    """Phase 7d's limits on the ranks' numbers and files; fills the
    per-rank rows' `launches` from rank 0's runs."""
    from vit_ae_plus_plus_torch.models import MODEL_ZOO

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    card = card_line()

    def rowed(counts: dict, what: str) -> None:
        unrowed = sorted(k for k in counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"{what} launched kernels at shapes that no row holds against plain: {unrowed}")

    # (a) the MAE step on (4, 1), and on (2, 1) in bf16
    for run, ranks in (("float32", GROUP_RANKS), ("bfloat16", GROUP_RANKS), ("pair", 2)):
        dtype = "bfloat16" if run != "float32" else "float32"
        tol, want_counts = STEP_TOL[dtype], ddp_step_launches(cfg, ranks, dtype)
        run_counts = Counter()
        for rank, res in enumerate(results[:ranks]):
            t = res["ddp"][run]
            print(f"ddp rank {rank} of {ranks} {dtype} MAE step vs phase 5's one-process step, step 1 relative "
                  f"errors: " + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
                  + f" (tol loss terms and statistics {tol['loss']}, grads {tol['grad']}); losses "
                  + ", ".join(f"{s['metrics']['loss']:.6f}" for s in t["steps"])
                  + f"; parameters' largest difference from rank 0 after {len(t['steps'])} steps: "
                  f"{t['params_max_diff']:.3g}", flush=True)
            print(f"ddp rank {rank} of {ranks} {dtype}, information only ({card}): step wall "
                  + ", ".join(f"{1e3 * s['wall_s']:.1f}" for s in t["steps"])
                  + " ms (host clock, synchronised; all-reduce included); host-staged "
                  + ", ".join(f"{s['staged_bytes'] / 1e6:.1f}" for s in t["steps"])
                  + f" MB a step; the gradient all-reduce alone ({t['grad_bytes'] / 1e6:.1f} MB, gloo through "
                  f"pinned host memory) " + ", ".join(f"{1e3 * x:.1f}" for x in t["allreduce_s"])
                  + f" ms; peak {t['peak_gib']:.2f} GiB", flush=True)
            for k, v in t["errs"].items():
                check(v <= (tol["grad"] if k in GRAD_NAMES else tol["loss"]),
                      f"ddp rank {rank} of {ranks} {dtype} MAE step {k}: {v:.3g}")
            check(t["params_max_diff"] == 0.0, f"ddp rank {rank} of {ranks}: {dtype} parameters differ from rank "
                  f"0's by {t['params_max_diff']:.3g}")
            for i, step in enumerate(t["steps"]):
                check(step["counts"] == want_counts, f"ddp rank {rank} of {ranks} {dtype} step {i + 1} launched "
                      f"{step['counts']} (want {want_counts})")
                if rank == 0:
                    run_counts.update(step["counts"])
        rowed(run_counts, f"the {dtype} data-parallel step on {ranks} ranks")
        fill_launches(rows, run_counts, f"make_train_step, compute_dtype='{dtype}', {TRAIN_STEPS} steps on a "
                      f"({ranks}, 1) data mesh, rank 0 of {ranks}")
    print(f"ddp, information only ({card}): the one-process bf16 step's wall "
          + ", ".join(f"{1e3 * x:.1f}" for x in refs["one_process_walls"])
          + " ms (host clock, synchronised, phase 5's trainer and batch)", flush=True)
    tol = STEP_TOL["float32"]
    for rank, res in enumerate(results):
        errs = res["ddp"]["control"]["errs"]
        missed = {k: v for k, v in errs.items() if v > (tol["grad"] if k in GRAD_NAMES else tol["loss"])}
        print(f"ddp rank {rank} f32 control, BatchNorm moments left local: " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
        check(bool(missed), f"ddp rank {rank}: the local-moments control passed the f32 gate ({errs})")

    # (b) the fine-tune step with mixup
    vit = ddp_shapes(cfg, GROUP_RANKS)[2]
    want_counts = {(f"packed_flash_{way}", (*vit, "float32")): cfg.depth for way in ("fwd", "bwd")}
    tol = STEP_TOL["float32"]
    for rank, res in enumerate(results):
        f = res["ddp"]["finetune"]
        print(f"ddp rank {rank} f32 fine-tune step with timm mixup vs one process: " + ", ".join(
            f"{k} {v:.3g}" for k, v in f["errs"].items()) + f" (tol loss {tol['loss']}, grads {tol['grad']})",
              flush=True)
        check(all(v <= (tol["loss"] if k == "loss" else tol["grad"]) for k, v in f["errs"].items()),
              f"ddp rank {rank} fine-tune step: {f['errs']}")
        check(f["counts"] == want_counts, f"ddp rank {rank} fine-tune step launched {f['counts']}")
    rowed(results[0]["ddp"]["finetune"]["counts"], "the data-parallel fine-tune step")
    fill_launches(rows, results[0]["ddp"]["finetune"]["counts"],
                  f"make_supervised_steps with mixup, f32, one step on a ({GROUP_RANKS}, 1) data mesh, rank 0")

    # (c) pretrain_kfold and (d) extract_ssl_features: one writer, the
    # one-process files in the one-process order
    ranks_work, one_work = paths["ranks_work"], paths["one_work"]
    pth = "checkpoints/fold_0/checkpoint-min_loss.pth"
    got_files, one_files = files_under(ranks_work), files_under(one_work)
    feat_names = [f"ssl_features_dir/{t}_contrast_ssl_{w}_split_0.npy" for t in ("test", "train")
                  for w in ("features", "labels")]
    check([f for f in got_files if not f.startswith("logs/")] == sorted([".writer.lock", "checkpoints/log.txt", pth,
                                                                          *feat_names]),
          f"ddp pretrain_kfold wrote {got_files}")
    check(len([f for f in got_files if f.startswith("logs/")]) == 1, f"ddp pretrain_kfold TensorBoard files {got_files}")
    logged = {}
    for run in ("ranks_work", "one_work", "control_work"):
        with open(os.path.join(paths[run], "checkpoints", "log.txt")) as f:
            logged[run] = [json.loads(line) for line in f]
        check(len(logged[run]) == 1 and np.isfinite(logged[run][0]["train_loss"]), f"ddp {run} log.txt {logged[run]}")
    check(logged["ranks_work"][0]["train_lr"] == logged["one_work"][0]["train_lr"] > 0,
          f"ddp pretrain_kfold train_lr {logged['ranks_work'][0]['train_lr']} against one process's at "
          f"{GROUP_RANKS} x blr {logged['one_work'][0]['train_lr']}")
    want_loss, tol = logged["one_work"][0]["train_loss"], DDP_LOSS_TOL
    loss_errs = {run: abs(logged[run][0]["train_loss"] - want_loss) / abs(want_loss)
                 for run in ("ranks_work", "control_work")}
    print(f"ddp pretrain_kfold on {GROUP_RANKS} ranks, log.txt train_loss (the epoch's mean of 3 steps at "
          f"lr {logged['one_work'][0]['train_lr']:.4g} last): {logged['ranks_work'][0]['train_loss']:.6f} against one "
          f"process's {want_loss:.6f}, rel err {loss_errs['ranks_work']:.3g} (tol {tol}); the control, gradients "
          f"left unaveraged: {logged['control_work'][0]['train_loss']:.6f}, rel err "
          f"{loss_errs['control_work']:.3g} (must miss)", flush=True)
    check(loss_errs["ranks_work"] <= tol, f"ddp pretrain_kfold train_loss: rel err {loss_errs['ranks_work']:.3g}")
    check(loss_errs["control_work"] > tol, f"ddp pretrain_kfold control (gradients unaveraged) passed the "
          f"train_loss gate: rel err {loss_errs['control_work']:.3g}")
    errs = {}
    for name in feat_names:
        got, want = np.load(os.path.join(ranks_work, name)), np.load(os.path.join(one_work, name))
        check(got.shape == want.shape and got.dtype == want.dtype, f"ddp {name}: {got.shape} {got.dtype}")
        if "labels" in name:
            check(np.array_equal(got, want), f"ddp {name}: labels differ from one process's")
        else:
            errs[name] = rel_err(got, want)
    pre, ext = results[0]["ddp"]["pretrain"], results[0]["ddp"]["extract"]
    print(f"ddp pretrain_kfold on {GROUP_RANKS} ranks (fold 0, 1 epoch of 3 steps, bf16) vs one process: features "
          + ", ".join(f"{n.split('/')[1]} {e:.3g}" for n, e in errs.items()) + f" (tol {ENGINE_TOL['bfloat16']}); "
          f"files {len(got_files)} (one process {len(one_files)}); wall {pre['wall_s']:.2f} s, one process "
          f"{refs['pretrain_s']:.2f} s ({card}, information only)", flush=True)
    check(all(e <= ENGINE_TOL["bfloat16"] for e in errs.values()), f"ddp pretrain_kfold features: {errs}")
    errs = {}
    for split in ("train", "test"):
        got = np.load(os.path.join(paths["ranks_features"], f"{split}_features.npy"))
        want = np.load(os.path.join(paths["features"], f"{split}_features.npy"))
        check(got.shape == want.shape, f"ddp extract {split}: {got.shape} (want {want.shape})")
        check(np.array_equal(np.load(os.path.join(paths["ranks_features"], f"{split}_gt_labels.npy")),
                             np.load(os.path.join(paths["features"], f"{split}_gt_labels.npy"))),
              f"ddp extract {split} labels")
        errs[split] = rel_err(got, want)
    print(f"ddp extract_ssl_features on {GROUP_RANKS} ranks vs phase 5e's extract-features files: "
          + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" (tol {ENGINE_TOL['bfloat16']}); wall "
          f"{ext['wall_s']:.2f} s ({card}, information only)", flush=True)
    check(all(e <= ENGINE_TOL["bfloat16"] for e in errs.values()), f"ddp extract features: {errs}")
    enc, dec, vit = ddp_shapes(cfg, GROUP_RANKS)
    slab_counts = {("packed_flash_fwd", (*vit, "bfloat16")): cfg.depth * 2 * slabs(24)}
    want_pre = {k: TRAIN_STEPS * n for k, n in ddp_step_launches(cfg, GROUP_RANKS, "bfloat16").items()}
    want_pre.update(slab_counts)
    n_extract = sum(len(np.load(os.path.join(paths["split"], f"y_{m}_ssl.npy"))) for m in ("train", "test"))
    for rank, res in enumerate(results):
        check(res["ddp"]["pretrain"]["counts"] == want_pre, f"ddp rank {rank} pretrain_kfold launched "
              f"{res['ddp']['pretrain']['counts']} (want {want_pre})")
        check(sum(res["ddp"]["extract"]["counts"].values()) == cfg.depth * (slabs(38) + slabs(5))
              and set(res["ddp"]["extract"]["counts"]) == set(slab_counts),
              f"ddp rank {rank} extraction of {n_extract} volumes launched {res['ddp']['extract']['counts']}")
    for what, key in (("pretrain_kfold", "pretrain"), ("extract_ssl_features", "extract")):
        rowed(pre["counts"] if key == "pretrain" else ext["counts"], f"the data-parallel {what}")
        fill_launches(rows, results[0]["ddp"][key]["counts"], f"{what} on a ({GROUP_RANKS}, 1) data mesh, rank 0")
    check_ddp_moco(results, rows, refs, paths, rowed)  # (e), (f)


def check_ddp_moco(results: list, rows: list, refs: dict, paths: dict, rowed) -> None:
    """Phase 7d (e) and (f)'s limits on the ranks' numbers and files; fills
    the per-rank rows' `launches` from rank 0's runs."""
    card = card_line()

    def line(errs: dict) -> str:
        return ", ".join(f"{k} {v:.3g}" for k, v in errs.items())

    # (e) the MoCo step: f32 within phase 5g's limits, bf16 printed only
    for arch, dtype, ranks in MOCO_DDP_RUNS:
        ref = refs["moco"][arch][dtype]
        limits = ref.get("limits")
        want_counts = moco_step_launches(dtype, BATCH // ranks) if arch == "vit" else {}
        run_counts = Counter()
        for rank, res in enumerate(results[:ranks]):
            t = res["ddp"][f"moco_{arch}_{dtype}_{ranks}"]
            grad_mb = t["grad_bytes"] / 1e6
            print(f"ddp rank {rank} of {ranks} MoCo-{arch} {dtype} step vs phase 5g's one-process step: "
                  f"{line(t['errs'])}" + (f" (limits {line(limits)})" if limits else " (information: bf16 rounding "
                  "moves these as far, see MOCO_FLOOR_FACTOR)") + "; losses "
                  + ", ".join(f"{s['loss']:.6f}" for s in t["steps"])
                  + f"; parameters' largest difference from rank 0: {t['params_max_diff']:.3g}", flush=True)
            print(f"ddp rank {rank} of {ranks} MoCo-{arch} {dtype}, information only ({card}): step wall "
                  + ", ".join(f"{1e3 * s['wall_s']:.1f}" for s in t["steps"])
                  + " ms (host clock, synchronised); host stagings a step "
                  + ", ".join(f"{s['staged_calls']} of {s['staged_bytes'] / 1e6:.1f} MB" for s in t["steps"])
                  + f" (one the gradient all-reduce of {grad_mb:.1f} MB; the rest the BatchNorm moments and their "
                  f"gradients, the keys' gather and the loss: "
                  + ", ".join(f"{(s['staged_bytes'] - t['grad_bytes']) / 1e3:.1f} kB" for s in t["steps"])
                  + "); the gradient all-reduce alone " + ", ".join(f"{1e3 * x:.1f}" for x in t["allreduce_s"])
                  + f" ms; peak {t['peak_gib']:.2f} GiB", flush=True)
            if limits:
                bad = {k: v for k, v in t["errs"].items() if v > limits[k]}
                check(not bad, f"ddp rank {rank} of {ranks} MoCo-{arch} f32 step: {bad}")
            check(t["params_max_diff"] == 0.0, f"ddp rank {rank} of {ranks} MoCo-{arch} {dtype}: parameters differ "
                  f"from rank 0's by {t['params_max_diff']:.3g}")
            for i, step in enumerate(t["steps"]):
                check(step["counts"] == want_counts, f"ddp rank {rank} of {ranks} MoCo-{arch} {dtype} step {i + 1} "
                      f"launched {step['counts']} (want {want_counts})")
                if rank == 0:
                    run_counts.update(step["counts"])
        if run_counts:
            rowed(run_counts, f"the {dtype} data-parallel MoCo step on {ranks} ranks")
            fill_launches(rows, run_counts, f"make_moco_train_step, compute_dtype='{dtype}', one step on a "
                          f"({ranks}, 1) data mesh, rank 0 of {ranks}")
            for row in rows:
                n = run_counts.get((row["name"], row["key"]), 0)
                if n:
                    row.setdefault("moco_ddp_launches", {})[f"{dtype} ({ranks}, 1)"] = n
    limits = refs["moco"]["vit"]["float32"]["limits"]
    for control, keys in (("local_keys", ("loss",)), ("local_moments", ("predictor.1.running_var",))):
        for rank, res in enumerate(results):
            errs = res["ddp"][f"moco_{control}"]["errs"]
            print(f"ddp rank {rank} MoCo-ViT f32 control, {control.replace('_', ' ')}: {line(errs)}", flush=True)
            check(all(errs[k] > limits[k] for k in keys), f"ddp rank {rank}: the MoCo {control} control passed "
                  f"the f32 gate on {keys} ({errs})")

    # (e) moco_kfold: one writer, the one-process run's files, its losses
    ranks_work, one_work = paths["moco_ranks_work"], paths["moco_one_work"]
    got_files, one_files = files_under(ranks_work), files_under(one_work)
    check(got_files == one_files, f"ddp moco_kfold wrote {got_files} (one process {one_files})")
    logged = {}
    runs = ("moco_ranks_work", "moco_one_work", "moco_control_work", "moco_nudged_work")
    for run in runs:
        with open(os.path.join(paths[run], "log.txt")) as f:
            logged[run] = [json.loads(line) for line in f]
        check([(r["fold"], r["epoch"]) for r in logged[run]] == [(0, 0), (0, 1)]
              and all(np.isfinite(r["train_loss"]) for r in logged[run]), f"ddp {run} log.txt {logged[run]}")
    loss_errs = {run: max(abs(r["train_loss"] - w["train_loss"]) / abs(w["train_loss"])
                          for r, w in zip(logged[run], logged["moco_one_work"]))
                 for run in runs if run != "moco_one_work"}
    check(loss_errs["moco_nudged_work"] <= MOCO_KFOLD_FLOOR_CEIL["loss"], f"ddp moco_kfold: the floor run's "
          f"train_loss reads {loss_errs['moco_nudged_work']:.3g}, above MOCO_KFOLD_FLOOR_CEIL")
    limit = max(DDP_LOSS_TOL, MOCO_FLOOR_FACTOR * loss_errs["moco_nudged_work"])
    fmt = lambda run: ", ".join(f"{r['train_loss']:.7f}" for r in logged[run])  # noqa: E731
    print(f"ddp moco_kfold on {GROUP_RANKS} ranks (f32, fold 0: 2 epochs of 2 steps, lr 0.01875, no warmup), "
          f"log.txt train_loss {fmt('moco_ranks_work')} against one process's {fmt('moco_one_work')}, largest rel "
          f"err {loss_errs['moco_ranks_work']:.3g} (limit {limit:.3g}: DDP_LOSS_TOL or {MOCO_FLOOR_FACTOR} times the "
          f"floor, one process on its volumes scaled by 1 + 2^-20: {fmt('moco_nudged_work')}, "
          f"{loss_errs['moco_nudged_work']:.3g}); the control, gradients left unaveraged: "
          f"{fmt('moco_control_work')}, {loss_errs['moco_control_work']:.3g} (must miss)", flush=True)
    check(loss_errs["moco_ranks_work"] <= limit, f"ddp moco_kfold train_loss: {loss_errs['moco_ranks_work']:.3g}")
    check(loss_errs["moco_control_work"] > limit, f"ddp moco_kfold control (gradients unaveraged) passed the "
          f"train_loss gate: {loss_errs['moco_control_work']:.3g}")
    errs, floors = {}, {}
    for name in (f for f in one_files if f.startswith("ssl_features_dir/")):
        got, want = np.load(os.path.join(ranks_work, name)), np.load(os.path.join(one_work, name))
        check(got.shape == want.shape and got.dtype == want.dtype, f"ddp moco_kfold {name}: {got.shape} {got.dtype}")
        if "labels" in name:
            check(np.array_equal(got, want), f"ddp moco_kfold {name}: labels differ from one process's")
        else:
            errs[name.split("/")[1]] = rel_err(got, want)
            floors[name.split("/")[1]] = rel_err(np.load(os.path.join(paths["moco_nudged_work"], name)), want)
    check(max(floors.values()) <= MOCO_KFOLD_FLOOR_CEIL["features"], f"ddp moco_kfold: the floor run's features "
          f"read {line(floors)}, above MOCO_KFOLD_FLOOR_CEIL")
    feat_limit = max(ENGINE_TOL["float32"], MOCO_FLOOR_FACTOR * max(floors.values()))
    mk = results[0]["ddp"]["moco_kfold"]
    print(f"ddp moco_kfold on {GROUP_RANKS} ranks vs one process: features {line(errs)} (limit {feat_limit:.3g}: "
          f"ENGINE_TOL or {MOCO_FLOOR_FACTOR} times the floor run's {line(floors)}); files {len(got_files)}; wall "
          f"{mk['wall_s']:.2f} s, one process {refs['moco_kfold_s']:.2f} s ({card}, information only)", flush=True)
    check(all(e <= feat_limit for e in errs.values()), f"ddp moco_kfold features: {errs}")
    key = (BATCH // GROUP_RANKS, 12, (VOLUME // PATCH) ** 3 + 1, 64, "float32")
    want_counts = {("packed_flash_fwd", key): 4 * 48 + 12 * (slabs(2 * BATCH) + slabs(24)),
                   ("packed_flash_bwd", key): 4 * 24}
    for rank, res in enumerate(results):
        got = res["ddp"]["moco_kfold"]["counts"]
        check(got == want_counts, f"ddp rank {rank} moco_kfold launched {got} (want {want_counts})")
    rowed(mk["counts"], "the data-parallel moco_kfold")
    fill_launches(rows, mk["counts"], f"moco_kfold on a ({GROUP_RANKS}, 1) data mesh, rank 0")

    # (f) the contrastive step
    tol = STEP_TOL["float32"]
    want_counts = contrastive_launches("float32", BATCH // GROUP_RANKS)
    for rank, res in enumerate(results):
        t = res["ddp"]["contrastive_None"]
        print(f"ddp rank {rank} of {GROUP_RANKS} contrastive f32 step vs phase 5h's one-process step: "
              f"{line(t['errs'])} (tol loss {tol['loss']}, the rest {tol['grad']}); parameters' largest difference "
              f"from rank 0: {t['params_max_diff']:.3g}; information only ({card}): step wall "
              f"{1e3 * t['wall_s']:.1f} ms, {t['staged_calls']} host stagings of {t['staged_bytes'] / 1e6:.1f} MB, "
              f"peak {t['peak_gib']:.2f} GiB", flush=True)
        bad = {k: v for k, v in t["errs"].items() if v > (tol["loss"] if k == "loss" else tol["grad"])}
        check(not bad, f"ddp rank {rank} contrastive step: {bad}")
        check(t["params_max_diff"] == 0.0, f"ddp rank {rank} contrastive: parameters differ from rank 0's")
        check(t["counts"] == want_counts, f"ddp rank {rank} contrastive step launched {t['counts']}")
        errs = res["ddp"]["contrastive_local_moments"]["errs"]
        print(f"ddp rank {rank} contrastive f32 control, BatchNorm moments left local: {line(errs)}", flush=True)
        check(any(errs[k] > tol["grad"] for k in CONTR_STATS), f"ddp rank {rank}: the contrastive local-moments "
              f"control passed the f32 gate ({errs})")
    counts = results[0]["ddp"]["contrastive_None"]["counts"]
    rowed(counts, "the data-parallel contrastive step")
    fill_launches(rows, counts, f"make_contrastive_step, f32, one step on a ({GROUP_RANKS}, 1) data mesh, rank 0")
    for row in rows:
        n = counts.get((row["name"], row["key"]), 0)
        if n:
            row["contrastive_ddp_launches"] = n


def group_phase(rows: list, reference: dict, paths: dict, moco: dict, contrastive: dict, serving: dict) -> None:
    """Phase 7: run `group_rank` on 4 spawned ranks and hold their numbers
    to the limits; fills the ring rows' `launches` from rank 0's runs, and
    7d's per-rank rows'. `moco` and `contrastive`: phases 5g's and 5h's
    one-process steps."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import padded_len

    refs = ddp_references(reference, paths, moco, contrastive)
    refs["serving"] = serving
    gc.collect()
    torch.cuda.empty_cache()
    results = run_group(group_rank, refs, paths)
    check_group_attention(results)  # 7a

    # 7b: ViT-B features at 128^3 / p8: 12 blocks x 4 ring steps, or 12 shards
    cfg = MODEL_ZOO[MODEL](volume_size=GROUP_VOLUME, patch_size=PATCH)
    want_counts = {"flash_ring": {("ring_flash_fwd", group_key()): cfg.depth * GROUP_RANKS},
                   "flash_seq": {("flash_fwd", group_key()): cfg.depth}}
    for impl in ("flash_ring", "flash_seq"):
        for rank, res in enumerate(results):
            r = res["vit"][impl]
            print(f"group rank {rank} ViT-B {GROUP_VOLUME}^3/p{PATCH} batch 2 bf16 {impl}: features vs flash rel err "
                  f"{r['rel_err']:.3g} (tol {ENGINE_TOL['bfloat16']}); launched {r['counts']}; engine.infer "
                  f"{r['infer_ms']:.1f} ms (host clock, information only)", flush=True)
            check(r["ok"] and r["rel_err"] <= ENGINE_TOL["bfloat16"], f"rank {rank} {impl} features: {r['rel_err']}")
            check(r["counts"] == want_counts[impl], f"rank {rank} {impl} ViT launched {r['counts']}")
        fill_launches(rows, results[0]["vit"][impl]["counts"],
                      f"FeatureEngine(attn_impl='{impl}') at {GROUP_VOLUME}^3, one slab of 2, rank 0 of {GROUP_RANKS}")
    for impl, fn in (("flash_ring", "ring_flash_attention"), ("flash_seq", "seq_sharded_flash_attention")):
        fill_launches(rows, results[0]["attention"][impl]["counts"],  # the backward rows at N4097
                      f"{fn} forward and backward at N4097, rank 0 of {GROUP_RANKS}")

    # 7c: the MAE step with flash_ring: every block's attention in P ring steps
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    per_step = {}
    for (b, h, n, d), depth in zip(train_shapes(cfg), (cfg.depth, cfg.decoder_depth)):
        key = (b, h, padded_len(n, GROUP_RANKS) // GROUP_RANKS, d, "bfloat16")
        per_step.update({("ring_flash_fwd", key): depth * GROUP_RANKS, ("ring_flash_bwd", key): depth * GROUP_RANKS})
    for dtype in ("bfloat16", "float32"):
        tol = STEP_TOL[dtype]
        want_counts = {(name, (*key[:-1], dtype)): n for (name, key), n in per_step.items()}
        run_counts = Counter()
        for rank, res in enumerate(results):
            t = res["train"][dtype]
            steps = len(t["steps"])
            print(f"group rank {rank} train {dtype} flash_ring vs phase 5's {dtype} step (attn_impl='auto'), step 1 "
                  f"relative errors: " + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
                  + f" (tol loss terms {tol['loss']}, grads {tol['grad']}); losses "
                  + ", ".join(f"{s['metrics']['loss']:.6f}" for s in t["steps"])
                  + f"; step wall " + ", ".join(f"{s['wall_s']:.2f}" for s in t["steps"])
                  + f" s; peak {t['peak_gib']:.2f} GiB; parameters' largest difference from rank 0 after "
                  f"{steps} steps: {t['params_max_diff']:.3g}", flush=True)
            for k, v in t["errs"].items():
                check(v <= (tol["grad"] if k in GRAD_NAMES else tol["loss"]),
                      f"rank {rank} {dtype} flash_ring train {k}: {v:.3g}")
            # the replicated trunk is right only while every rank holds the same weights
            check(t["params_max_diff"] == 0.0, f"rank {rank}: {dtype} parameters differ from rank 0's by "
                  f"{t['params_max_diff']:.3g} after {steps} flash_ring steps")
            for i, step in enumerate(t["steps"]):
                check(step["counts"] == want_counts, f"rank {rank} {dtype} flash_ring step {i + 1} launched "
                      f"{step['counts']} (want {want_counts})")
                if rank == 0:
                    run_counts.update(step["counts"])
        unrowed = sorted(k for k in run_counts if not any((r["name"], r["key"]) == k for r in rows))
        check(not unrowed, f"the {dtype} flash_ring step launched kernels at shapes that no row holds against "
              f"plain: {unrowed}")
        fill_launches(rows, run_counts, f"make_train_step, compute_dtype='{dtype}', attn_impl='flash_ring', "
                      f"{len(results[0]['train'][dtype]['steps'])} steps, rank 0 of {GROUP_RANKS}")
    check_ddp(results, rows, refs, paths)  # 7d
    check_sharded(results, rows, refs)  # 7e
    check_pipe(results, rows)  # 7f
    check_serving_mesh(results, rows, refs)  # 7g
    check_mesh_steps(results, rows, refs)  # 7h


def main(argv) -> int:
    import torch

    parent = None
    if argv:
        if len(argv) != 2 or argv[0] != "--parent" or not (Path(argv[1]) / "chip_smoke.py").is_file():
            print("usage: chip_smoke.py [--parent CHECKOUT]", file=sys.stderr)
            return 2
        parent = Path(argv[1]).resolve()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "vit_ae_plus_plus_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vit_ae_plus_plus_torch.kernels import _build
    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.serving import FeatureEngine
    from vit_ae_plus_plus_torch.train.step import feature_step

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 comparisons stay f32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    # phase 1: build every kernel source, all nvcc processes at once (and,
    # with --parent, the parent checkout's beside them)
    t0 = time.perf_counter()
    parent_build = None
    if parent is not None:
        parent_build = subprocess.Popen(
            [sys.executable, "-c", "from vit_ae_plus_plus_torch.kernels import _build; _build.build()"],
            cwd=parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        atexit.register(stop, parent_build)
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions at the serving shapes
    cases = [
        ("packed bf16 N1729 d64", "packed", 8, 12, 1729, 64, "bfloat16"),
        ("per-head bf16 N1729 d64", "per_head", 8, 12, 1729, 64, "bfloat16"),
        ("per-head bf16 N4097 d64", "per_head", 8, 12, 4097, 64, "bfloat16"),
        ("per-head bf16 N1729 d32", "per_head", 8, 16, 1729, 32, "bfloat16"),
        ("packed f32 N1729 d64", "packed", 8, 12, 1729, 64, "float32"),
    ]
    rows = [kernel_case(*c, seed=i) for i, c in enumerate(cases)]
    # and at the shapes of the training step: the masked encoder over both
    # views (2B = 16, 433 tokens, d 64) and the decoder (1,729 tokens, d 32),
    # both layouts (the per-head forward at the decoder's shape is the
    # N1729 d32 case above), and the per-head backward at N1729 d64
    enc, dec = (2 * BATCH, 12, 433, 64), (BATCH, 16, 1729, 32)
    train_cases = [
        (kernel_case, "packed bf16 N433 d64 (encoder)", "packed", enc, "bfloat16"),
        (kernel_case, "packed bf16 N1729 d32 (decoder)", "packed", dec, "bfloat16"),
        (bwd_case, "packed bwd bf16 N433 d64 (encoder)", "packed", enc, "bfloat16"),
        (bwd_case, "packed bwd bf16 N1729 d32 (decoder)", "packed", dec, "bfloat16"),
        (kernel_case, "per-head bf16 N433 d64 (encoder)", "per_head", enc, "bfloat16"),
        (bwd_case, "per-head bwd bf16 N433 d64 (encoder)", "per_head", enc, "bfloat16"),
        (bwd_case, "per-head bwd bf16 N1729 d32 (decoder)", "per_head", dec, "bfloat16"),
        (bwd_case, "per-head bwd bf16 N1729 d64", "per_head", (BATCH, 12, 1729, 64), "bfloat16"),
        (bwd_case, "packed bwd f32 N1729 d32 (decoder)", "packed", dec, "float32"),
        (kernel_case, "packed f32 N433 d64 (encoder)", "packed", enc, "float32"),
        (kernel_case, "packed f32 N1729 d32 (decoder)", "packed", dec, "float32"),
        (bwd_case, "packed bwd f32 N433 d64 (encoder)", "packed", enc, "float32"),
        (bwd_case, "per-head bwd f32 N433 d64 (encoder)", "per_head", enc, "float32"),
        (bwd_case, "per-head bwd f32 N1729 d32 (decoder)", "per_head", dec, "float32"),
        # the fine-tune step's shape (phase 5e), packed, bf16 and f32
        (bwd_case, "packed bwd bf16 N1729 d64 (fine-tune)", "packed", (BATCH, 12, 1729, 64), "bfloat16"),
        (bwd_case, "packed bwd f32 N1729 d64 (fine-tune)", "packed", (BATCH, 12, 1729, 64), "float32"),
        # the opt-in contr_mae_vit_base_patch16_fast preset's step (d = 128:
        # 6 encoder heads, 4 decoder heads): the f32 backward bodies at d =
        # 128, packed and per-head, and the other d = 128 rows, measured
        (bwd_case, "packed bwd f32 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, "float32"),
        (bwd_case, "packed bwd f32 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, "float32"),
    ]
    rows += [case(label, layout, *shape, dtype, seed=10 + i)
             for i, (case, label, layout, shape, dtype) in enumerate(train_cases)]
    fast_cases = [
        (bwd_case, "per-head bwd f32 N433 d128 (encoder, fast preset)", "per_head", FAST_ENC, "float32"),
        (bwd_case, "per-head bwd f32 N1729 d128 (decoder, fast preset)", "per_head", FAST_DEC, "float32"),
        (bwd_case, "packed bwd bf16 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, "bfloat16"),
        (bwd_case, "packed bwd bf16 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, "bfloat16"),
        (kernel_case, "packed f32 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, "float32"),
        (kernel_case, "packed f32 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, "float32"),
        (kernel_case, "packed bf16 N433 d128 (encoder, fast preset)", "packed", FAST_ENC, "bfloat16"),
        (kernel_case, "packed bf16 N1729 d128 (decoder, fast preset)", "packed", FAST_DEC, "bfloat16"),
    ]
    rows += [case(label, layout, *shape, dtype, seed=90 + i)
             for i, (case, label, layout, shape, dtype) in enumerate(fast_cases)]
    # a ring block at d = 128 in f32: the fast decoder over 4 ranks, the
    # block with the padded key tail (the HAS_BIAS instances of the bodies)
    rows += ring_case("ring f32 NB440 d128 (fast decoder)", *FAST_DEC[:3], 128, GROUP_RANKS, seed=98,
                      dtype_name="float32")
    encoder_breakdown(*enc)
    # kernels #6 and #7 at the shapes of the ln_fusion="on" paths: each
    # block's qkv (F = 3C) and fc1 (F = 4C) in the training encoder and
    # decoder and in one serving slab, the training shapes in f32 too, and
    # the LayerNorm at the encoder's and the decoder's (R, C)
    t0 = time.perf_counter()
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    shapes = ln_shapes(cfg)
    for i, (where, (r, c)) in enumerate(shapes.items()):
        for j, (layer, f) in enumerate((("qkv", 3 * c), ("fc1", 4 * c))):
            rows += ln_dense_cases(f"ln_dense bf16 {where} {layer} R{r} C{c} F{f}", r, c, f, "bfloat16",
                                   seed=40 + 2 * i + j)
    for label, r, c, f, seed in f32_lnd_cases(cfg):
        rows += ln_dense_cases(label, r, c, f, "float32", seed=seed)
    for i, where in enumerate(("encoder", "decoder")):
        r, c = shapes[where]
        rows += layernorm_cases(f"layernorm bf16 {where} R{r} C{c}", r, c, "bfloat16", seed=60 + i)
    print(f"LayerNorm kernel cases {time.perf_counter() - t0:.1f}s", flush=True)
    # the per-rank shapes of phase 7d's data-parallel paths
    t0 = time.perf_counter()
    rows += [case(label, "packed", *shape, dtype, seed=110 + i)
             for i, (case, label, shape, dtype) in enumerate(ddp_cases(cfg))]
    # the int8 engine on a rank of phase 7g's serving mesh: the per-head
    # kernel at BATCH / 4 volumes (the bf16 engines' packed rows at that
    # shape are the extraction rows above)
    rows.append(kernel_case("per-head bf16 N1729 d64 (int8 engine, a rank of 4)", "per_head", BATCH // GROUP_RANKS,
                            12, cfg.num_patches + 1, 64, "bfloat16", seed=140))
    print(f"data-parallel kernel cases {time.perf_counter() - t0:.1f}s", flush=True)
    # the per-head kernels at phase 7e's TP shapes (H / M heads a rank)
    t0 = time.perf_counter()
    tp_cases, sharded_rings = sharded_cases(cfg)
    rows += [case(label, layout, *shape, dtype, seed=150 + i)
             for i, (case, label, layout, shape, dtype) in enumerate(tp_cases)]
    print(f"tensor-parallel kernel cases {time.perf_counter() - t0:.1f}s", flush=True)
    # the per-head kernels at phase 7f's GPipe microbatches ('flash_local')
    t0 = time.perf_counter()
    rows += [case(label, "per_head", *shape, dtype, seed=170 + i)
             for i, (case, label, shape, dtype) in enumerate(pipe_cases(cfg))]
    print(f"pipeline kernel cases {time.perf_counter() - t0:.1f}s", flush=True)
    # the packed forward at one volume's shapes (phase 5j's reconstruction)
    rows += [kernel_case(f"packed bf16 {where}", "packed", *shape, "bfloat16", seed=190 + i)
             for i, (where, shape) in enumerate(recon_shapes(cfg))]

    # phase 3: the full-width ViT-B feature engine, kernel against plain
    tree = mae_encoder_tree(cfg, seed=0)
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH)
    engine = FeatureEngine(mae_params=tree, **common)
    plain = FeatureEngine(mae_params=tree, attn_impl="plain", **common)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"engine warm in {time.perf_counter() - t0:.1f}s", flush=True)
    vols = np.random.default_rng(5).standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32)
    feats, counts = path_launches(engine, vols)
    ref = plain.infer(vols)
    check(feats.shape == (BATCH, cfg.embed_dim) and bool(np.isfinite(feats).all()), "engine features")
    check(totals(counts) == {**NO_LAUNCHES, "packed_flash_fwd": 12},
          f"one slab launched {totals(counts)} (want 12 packed forward and nothing else)")
    err = rel_err(feats, ref)
    print(f"engine bf16: features vs attn_impl=plain rel err {err:.3g} (tol {ENGINE_TOL['bfloat16']})")
    check(err <= ENGINE_TOL["bfloat16"], f"engine features vs plain: rel err {err:.3g}")

    # phase 4: the main path, served over HTTP
    _, counts = serve_phase(engine)
    fill_launches(rows, counts, "serve: POST /features through BatchingQueue (attn_impl='auto')")

    # phase 4b: the same slab through the ln_fusion="on" trunk
    fused_vit_phase(engine, vols, feats, rows)

    # the per-head kernel's path and the f32 path, counts read around each
    flash = FeatureEngine(mae_params=tree, attn_impl="flash", **common)
    flash_feats, counts = path_launches(flash, vols)
    check(totals(counts) == {**NO_LAUNCHES, "flash_fwd": 12},
          f"flash path launched {totals(counts)} (want 12 per-head forward and nothing else)")
    fill_launches(rows, counts, "FeatureEngine(attn_impl='flash').infer, one slab")
    err_flash = rel_err(flash_feats, ref)
    same = float(np.abs(flash_feats - feats).max())
    print(f"engine bf16 attn_impl=flash: rel err vs plain {err_flash:.3g}, max diff vs packed {same:.3g}")
    check(err_flash <= ENGINE_TOL["bfloat16"], f"flash engine vs plain: rel err {err_flash:.3g}")

    f32 = FeatureEngine(mae_params=tree, compute_dtype="float32", **common)
    f32_plain = FeatureEngine(mae_params=tree, compute_dtype="float32", attn_impl="plain", **common)
    f32_feats, counts = path_launches(f32, vols)
    check(totals(counts) == {**NO_LAUNCHES, "packed_flash_fwd": 12}, f"f32 path launched {totals(counts)}")
    fill_launches(rows, counts, "FeatureEngine(compute_dtype='float32').infer, one slab")
    err32 = rel_err(f32_feats, f32_plain.infer(vols))
    print(f"engine f32: features vs attn_impl=plain rel err {err32:.3g} (tol {ENGINE_TOL['float32']}); "
          f"bf16 vs f32 features rel err {rel_err(feats, f32_feats):.3g}")
    check(err32 <= ENGINE_TOL["float32"], f"f32 engine vs plain: rel err {err32:.3g}")

    times = {name: slab_ms(e, vols) for name, e in
             (("bf16 auto", engine), ("bf16 plain", plain), ("bf16 flash", flash), ("f32 auto", f32))}
    print("engine.infer ms per slab of 8 from host numpy (host clock, synchronised): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items()), flush=True)
    slab = torch.from_numpy(vols).cuda()
    device_ms = cuda_ms(lambda: feature_step(engine.model, slab), reps=5)
    print(f"engine bf16 auto forward_features on a device slab: {device_ms:.2f} ms (CUDA events)", flush=True)
    print(f"engine bf16 auto: {BATCH / times['bf16 auto'] * 1e3:.1f} volumes/s through engine.infer; "
          f"12 attention launches {12 * rows[0]['ms']:.2f} ms = {12 * rows[0]['ms'] / device_ms:.1%} "
          f"of the device forward", flush=True)
    f32_device_ms = cuda_ms(lambda: feature_step(f32.model, slab), reps=3)
    f32_attn_ms = 12 * next(r["ms"] for r in rows if r["key"] == (BATCH, 12, cfg.num_patches + 1, 64, "float32"))
    print(f"engine f32 auto forward_features on a device slab: {f32_device_ms:.2f} ms (CUDA events); "
          f"12 attention launches {f32_attn_ms:.2f} ms = {f32_attn_ms / f32_device_ms:.1%}", flush=True)
    profile_run(lambda: feature_step(f32.model, slab), "f32 slab", f32_device_ms)

    # phase 4c: the classifier ensemble, /predict, NIfTI and resized
    # requests, the int8 engines
    q_feat, ens = classify_phase(engine, tree, rows, device_ms)
    # phase 4d: the engine artifacts (compile-engine / serve --engine)
    serving_refs = artifact_phase({"features": engine, "int8": q_feat, "classify": ens}, classify_volumes(),
                                  tree, rows)
    del q_feat, ens
    gc.collect()
    torch.cuda.empty_cache()

    # phase 5: the pretraining step at full width (5b: ln_fusion="on")
    t0 = time.perf_counter()
    reference = train_phase(rows)
    print(f"train phase {time.perf_counter() - t0:.1f}s", flush=True)
    # phase 5c: the host data path feeds the step; 5d: pretrain-kfold on its
    # split; 5e: the downstream commands on 5d's work dir
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        split_dir, step_times = data_phase(Path(tmp))
        pre_work = pretrain_phase(split_dir, step_times)
        downstream_phase(split_dir, pre_work, rows)
        # phase 5f: the supervised ResNet baseline and the classical
        # evaluation of 5d's features
        resnet_step_phase()
        resnet_kfold_phase(split_dir)
        eval_classical_phase(pre_work / "ssl_features_dir")
        eval_classical_linear_phase(pre_work / "ssl_features_dir")
        eval_classical_rf_phase(pre_work / "ssl_features_dir")
        # phase 5g: the MoCo-v3 baseline, its step and its commands
        t0 = time.perf_counter()
        moco_refs = moco_step_phase(rows)
        moco_kfold_phase(split_dir)
        print(f"MoCo phase {time.perf_counter() - t0:.1f}s", flush=True)
        # phase 5h: contrastive-train, its step and the command
        contrastive_ref = contrastive_step_phase(rows)
        contrastive_command_phase(split_dir)
        # phase 5i: the options off the default path (augmentation on the
        # card, resident data, the VGG term, accumulation, the command)
        t0 = time.perf_counter()
        augment_phase()
        resident_phase(split_dir, step_times)
        perceptual_case()
        perceptual_grad_case()
        accum_case()
        options_command_phase(split_dir)
        print(f"options phase {time.perf_counter() - t0:.1f}s", flush=True)
        # phase 5j: the tooling (profile-attrib, doctor, export-torch,
        # sanity-viz, the reference-faithful step and the FLOPs)
        tooling_phase(split_dir, pre_work, rows, step_times, Path(tmp))
        fused_layernorm_run(rows, cfg)

        # phase 6: the ring's partial kernels at the ring blocks of phase 7 (the
        # feature path's, the step's decoder's and encoder's), a fully padded
        # block, and the sequence-sharded shard of 1,032 rows against 4,097 keys
        for i, (label, b, h, n, d) in enumerate(ring_shapes(cfg)):
            rows += ring_case(label, b, h, n, d, GROUP_RANKS, seed=70 + i)
        # the f32 flash_ring step's blocks (phase 7c): the decoder's and the encoder's
        for i, (label, b, h, n, d) in enumerate(ring_shapes(cfg)[1:]):
            rows += ring_case(label.replace("bf16", "f32"), b, h, n, d, GROUP_RANKS, seed=76 + i, dtype_name="float32")
        rows += ring_case("ring bf16 NB1032 d64, every key padded", 2, 12, 4097, 64, GROUP_RANKS, seed=75,
                          full_pad=True)
        rows += seq_case("seq bf16 N1032 Nk4097 d64", 2, 12, 4097, 64, GROUP_RANKS, seed=80)
        # phase 7e's (2, 2) flash_ring step: its encoder's and decoder's blocks over 2
        for i, (label, b, h, n, d) in enumerate(sharded_rings):
            rows += ring_case(label, b, h, n, d, 2, seed=85 + i)

        # with --parent: the redesigned rows in turns against the parent's bodies
        if parent is not None:
            in_turns_phase(rows, cfg, parent, parent_build)

        # phase 7: the sequence-parallel paths in a group of ranks on the
        # card, then (7d) data parallelism over the same ranks on 5c's split
        # and 5d's and 5e's files
        paths = {"split": str(split_dir), "features": str(split_dir.parent / "features"),
                 "pth": str(pre_work / "checkpoints" / "fold_0" / "checkpoint-min_loss.pth"),
                 **{name: str(Path(tmp) / f"ddp_{name}")
                    for name in ("ranks_work", "one_work", "control_work", "ranks_features", "moco_ranks_work",
                                 "moco_one_work", "moco_control_work", "moco_nudged_work", "pipe_work")}}
        group_phase(rows, reference, paths, moco_refs, contrastive_ref, serving_refs)
    for row in rows:
        if row["launches"] is None:
            row["launches"], row["path"] = 0, "none: a reference case at a shape no path runs"
        del row["key"]
    check(all(any(r["launches"] for r in rows if r["name"] == name) for name in WRAPPERS),
          "a kernel was launched by no path")
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
