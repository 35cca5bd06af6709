#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit when it fails:

1. print the card and build the CUDA kernels from the repository's sources;
2. hold every kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it, and time kernel, plain
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
   f32 backward's path); step time, volumes/s, peak memory and a
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
6. the ring's partial kernels (csrc/flash_fwd.cu and flash_bwd.cu with a
   key bias) against their plain versions at the ring blocks of the paths
   in phase 7, each the block that holds the padded tail, and at a fully
   padded block (correctness only); the per-head kernels with 1,032 query
   rows against 4,097 keys (the sequence-sharded shard); library times
   from `scaled_dot_product_attention` with the bias as a float mask, the
   fastest fused backend that takes it named;
   6b. with `--parent DIR` (a checkout of another commit), the f32
   attention backward rows of the training step (its encoder and decoder
   shapes, packed and per-head) timed in turns against DIR's bodies: each
   checkout's own case functions in a process of its own, parent, this
   checkout, this checkout, parent; the rows' `in_turns` hold the four
   times (null without `--parent`); each turn also times the f32 step
   (TrainConfig's default dtype), unfused and with `ln_fusion="on"`;
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
import gc
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MODEL = "contr_mae_vit_base_patch16"
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
    ("fwd", "float32"): "flash_fwd_f32_kernel (3xTF32 on mma.sync)",
    ("bwd", "bfloat16"): "flash_bwd_delta_kernel + flash_bwd_dkdv_wgmma_kernel + flash_bwd_dq_wgmma_kernel "
                         "(wgmma + TMA)",
    ("bwd", "float32"): "flash_bwd_delta_kernel + flash_bwd_split_kernel + flash_bwd_dkdv_tf32_kernel + "
                        "flash_bwd_dq_tf32_kernel (3xTF32 on wgmma + TMA; at d = 128, the opt-in fast preset's "
                        "head dim, flash_bwd_dkdv_f32_kernel + flash_bwd_dq_f32_kernel, scalar)",
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
TIMED_STEPS = 5
GROUP_RANKS = 4  # the 'model' group of phase 7, all on the one card
GROUP_VOLUME = 128  # 128^3 / patch 8: 4,097 tokens, a length the sequence-parallel paths exist for
GROUP_TIMEOUT = 600.0  # seconds for the whole of phase 7, spawn and joins included

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
    torch.cuda.synchronize()
    library = sdpa_calls(heads, scale)
    times = (graph_ms(kernel), graph_ms(plain, calls=3, reps=2), *sdpa_bwd_ms(library, leaves, do_heads))
    torch.cuda.empty_cache()
    row = {"name": "packed_flash_bwd" if layout == "packed" else "flash_bwd", "replaces": BWD_REPLACES[layout],
           "shape": f"B={b} H={h} N={n} d={d}", "dtype": dtype_name, "key": (b, h, n, d, dtype_name)}
    elt = torch.empty((), dtype=dtype).element_size()
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


def ring_case(label, b, h, n, d, shards, seed, full_pad=False):
    """Phase 6 for one ring block, forward and backward: rank 0's query rows
    against the last rank's block (where the padded tail lies; K and V pad
    rows are zeros, as the ring pads them) with its key bias, or with every
    key padded (`full_pad`). The backward takes the o and lse of each row
    over the whole sequence, as the merge hands them over. SDPA takes the
    bias as a bf16 float mask."""
    import torch

    from vit_ae_plus_plus_torch.kernels import (
        attention_bwd_plain, attention_plain, ring_partial_bwd, ring_partial_fwd,
    )
    from vit_ae_plus_plus_torch.kernels.ring_flash import NEG_INF
    from vit_ae_plus_plus_torch.parallel import padded_len

    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale, pn = d**-0.5, padded_len(n, shards)
    nb = pn // shards
    rand = lambda rows: torch.randn((b, h, rows, d), generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
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
    library = sdpa_calls(lambda: leaves, scale, mask=bb.to(torch.bfloat16).view(1, 1, 1, nb))
    times = ((graph_ms(fwd), graph_ms(plain_fwd, calls=3, reps=2), *sdpa_fwd_ms(library)),
             (graph_ms(bwd), graph_ms(plain_bwd, calls=3, reps=2), *sdpa_bwd_ms(library, leaves, do)))
    torch.cuda.empty_cache()
    row = {"shape": f"B={b} H={h} NB={nb} d={d} (of N={n} over {shards})", "dtype": "bfloat16",
           "key": (b, h, nb, d, "bfloat16")}
    if full_pad:
        row.update(launches=0, path="none: a fully padded block, correctness only")
    lse_bias = b * h * nb * 4 + nb * 4  # the f32 lse and the f32 key bias
    return [
        fwd_row(label, {**row, "name": "ring_flash_fwd", "replaces": RING_REPLACES["fwd"]}, got, plain_fwd(),
                times[0], bound(b, h, nb, d, "bfloat16", 2, extra_bytes=lse_bias), lse_relative=full_pad),
        bwd_row(f"{label} bwd", {**row, "name": "ring_flash_bwd", "replaces": RING_REPLACES["bwd"]}, grads,
                plain_bwd(), times[1], bound(b, h, nb, d, "bfloat16", 2, bwd=True, extra_bytes=lse_bias)),
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
    """(row name, row key, case call) for every f32 attention backward row
    of the training step: its encoder and decoder shapes, packed and
    per-head (the seeds of `main`'s rows); the rows that `--parent` times in
    turns against another checkout's bodies. The calls are this script's
    case functions, which that checkout's copy has too."""
    enc, dec = train_shapes(cfg)
    heads = [("packed bwd f32 N433 d64 (encoder)", "packed", enc, 21),
             ("per-head bwd f32 N433 d64 (encoder)", "per_head", enc, 22),
             ("packed bwd f32 N1729 d32 (decoder)", "packed", dec, 18),
             ("per-head bwd f32 N1729 d32 (decoder)", "per_head", dec, 23)]
    return [("packed_flash_bwd" if layout == "packed" else "flash_bwd", (*shape, "float32"),
             f"bwd_case('{label}', '{layout}', {', '.join(map(str, shape))}, 'float32', seed={seed})")
            for label, layout, shape, seed in heads]


# One turn in another checkout: its own chip_smoke's case functions (each
# call once), each call's row of the given name -> its kernel ms; and the
# f32 training step's time (CUDA events over 3 steps after one warm-up),
# unfused and with ln_fusion="on", from that checkout's Trainer, as one JSON
# line
TURN_CHILD = """
import json, sys
import torch
import chip_smoke as cs
from vit_ae_plus_plus_torch.models import MODEL_ZOO
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
out, done = [], {}
for name, call in json.loads(sys.argv[1]):
    if call not in done:
        got = eval("cs." + call)
        done[call] = got if isinstance(got, list) else [got]
    out.append(next(r["ms"] for r in done[call] if r["name"] == name))
cfg = MODEL_ZOO[cs.MODEL](volume_size=cs.VOLUME, patch_size=cs.PATCH)
tree, stats = cs.mae_tree(cfg, seed=0)
views, _ = cs.train_inputs(cfg)
steps = {}
for fusion in ("auto", "on"):
    trainer = cs.Trainer(tree, stats, "float32", "auto", ln_fusion=fusion)
    steps[fusion] = cs.step_ms(trainer, views, reps=3)[0]
    del trainer
    torch.cuda.empty_cache()
print("TURN " + json.dumps({"ms": out, "step_ms": steps}))
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
    row gets `in_turns` {"parent_ms": [..], "ms": [..]}."""
    log, _ = parent_build.communicate(timeout=600)
    check(parent_build.returncode == 0, f"the parent checkout's kernels did not build:\n{log[-2000:]}")
    cases = turn_cases(cfg)
    t0 = time.perf_counter()
    first = turn_ms(parent, cases)
    mine = [turn_ms(REPO, cases) for _ in range(2)]
    last = turn_ms(parent, cases)
    for i, (name, key, _) in enumerate(cases):
        row = next(r for r in rows if r["name"] == name and r["key"] == key)
        row["in_turns"] = {"parent_ms": [first["ms"][i], last["ms"][i]],
                           "ms": [mine[0]["ms"][i], mine[1]["ms"][i]]}
        print(f"in turns {name} {key[:-1]}: parent {first['ms'][i]:.4f}, {last['ms'][i]:.4f} ms -> "
              f"{mine[0]['ms'][i]:.4f}, {mine[1]['ms'][i]:.4f} ms", flush=True)
    for fusion, what in (("auto", "unfused"), ("on", "ln_fusion='on'")):
        print(f"in turns, f32 step {what}, ms per step of {BATCH} (CUDA events over 3 steps): parent "
              f"{first['step_ms'][fusion]:.2f}, {last['step_ms'][fusion]:.2f} -> {mine[0]['step_ms'][fusion]:.2f}, "
              f"{mine[1]['step_ms'][fusion]:.2f}", flush=True)
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
    bridge, `make_adamw`, `create_train_state`, `make_train_step`."""

    def __init__(self, tree, stats, dtype: str, attn_impl: str, ln_fusion: str = "auto"):
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
        self.state = create_train_state(self.model, make_adamw(schedule, weight_decay=tc.weight_decay), seed=0)
        self.kw = dict(mask_ratio=tc.mask_ratio, contr_weight=tc.contr_weight)
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

    def all_grads_finite(self) -> bool:
        import torch

        return all(bool(torch.isfinite(p.grad).all()) for p in self.model.parameters())


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
    ("AdamW (foreach)", ("multi_tensor_apply",)),
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


def profile_run(fn, what: str, ms_events: float) -> None:
    """`fn` once under torch.profiler: the device kernels' time by family and
    by name (top 15), their count, and the device's busy share of `what`'s
    time measured without the profiler."""
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
    enc, dec = train_shapes(cfg)

    def per_step(prefix: str, dtype: str) -> dict:
        """The launches one step should make: one forward and one backward
        per block, at the encoder's and the decoder's shape."""
        return {(f"{prefix}_{way}", (*shape, dtype)): depth for way in ("fwd", "bwd")
                for shape, depth in ((enc, cfg.depth), (dec, cfg.decoder_depth))}

    def first_steps(trainer, steps, want_counts):
        before = trainer.model.blocks[0].attn.qkv.weight.detach().clone()
        out, run_counts = [], Counter()
        for i in range(steps):
            metrics, counts = trainer.run(views, noise[i])
            check(counts == want_counts, f"{trainer.label} {trainer.cfg.dtype} step {i + 1} launched "
                  f"{counts} (want {want_counts})")
            run_counts.update(counts)
            out.append((metrics, trainer.grads() if i == 0 else None))
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
    auto_step = per_step("packed_flash", "bfloat16")
    got, run_counts = first_steps(auto, TRAIN_STEPS, auto_step)
    fill_launches(rows, run_counts, f"make_train_step, attn_impl='auto', {TRAIN_STEPS} steps")
    tol = STEP_TOL["bfloat16"]
    hold("bf16 auto", step_rel_errs(got[0][0], want[0][0], got[0][1], want[0][1]), tol)
    print("train bf16 losses, steps 1-3: auto " + ", ".join(f"{m['loss']:.6f}" for m, _ in got)
          + "; plain " + ", ".join(f"{m['loss']:.6f}" for m, _ in want), flush=True)
    print(f"train bf16 step 1 metrics (auto): {json.dumps(got[0][0])}", flush=True)
    reference = {"metrics": got[0][0], "grads": {n: g.cpu().numpy() for n, g in got[0][1].items()}}

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
    [(fm, fgrads)], fcounts = first_steps(flash, 1, per_step("flash", "bfloat16"))
    fill_launches(rows, fcounts, "make_train_step, attn_impl='flash', one step")
    hold("bf16 flash", step_rel_errs(fm, want[0][0], fgrads, want[0][1]), tol)
    flash_ms, _ = step_ms(flash, views, reps=3)
    del flash
    torch.cuda.empty_cache()

    f32 = Trainer(tree, stats, "float32", "auto")
    f32_plain = Trainer(tree, stats, "float32", "plain")
    [(m32, g32)], c32 = first_steps(f32, 1, per_step("packed_flash", "float32"))
    fill_launches(rows, c32, "make_train_step, compute_dtype='float32', one step")
    [(mp, gp)], _ = first_steps(f32_plain, 1, {})
    hold("f32 auto", step_rel_errs(m32, mp, g32, gp), STEP_TOL["float32"])
    f32_ms, _ = step_ms(f32, views, reps=2)
    del f32
    torch.cuda.empty_cache()
    f32_flash = Trainer(tree, stats, "float32", "flash")
    [(mf, gf)], cf = first_steps(f32_flash, 1, per_step("flash", "float32"))
    fill_launches(rows, cf, "make_train_step, compute_dtype='float32', attn_impl='flash', one step")
    hold("f32 flash", step_rel_errs(mf, mp, gf, gp), STEP_TOL["float32"])
    del f32_flash, f32_plain
    torch.cuda.empty_cache()

    # 5b: ln_fusion="on" against "off" from the same start, counts read
    # around every step: the attention launches of the unfused step plus
    # one LayerNorm+Dense forward and backward at qkv and at fc1 per block
    shapes = ln_shapes(cfg)
    trunk = ((shapes["encoder"], shapes["decoder"]), (cfg.depth, cfg.decoder_depth))

    def fused_step(dtype):
        return {**per_step("packed_flash", dtype), **ln_dense_launches(trunk[0], dtype, depths=trunk[1])}

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
    [(m_off, g_off)], _ = first_steps(f32_off, 1, per_step("packed_flash", "float32"))
    hold("f32 ln_fusion=on", step_rel_errs(m_on, m_off, g_on, g_off), STEP_TOL["float32"], "ln_fusion=off")
    # both f32 steps timed in turns (on, off, on, off: a step's wall time
    # moves more between runs than its device time does) and profiled:
    # where the f32 step's device time goes
    f32_turns = {"on": [], "off": []}
    for which, trainer in (("on", f32_on), ("off", f32_off), ("on", f32_on), ("off", f32_off)):
        t_ms, timed = step_ms(trainer, views, reps=3)
        f32_turns[which].append(t_ms)
        want_timed = fused_step("float32") if which == "on" else per_step("packed_flash", "float32")
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
    the group's first rank after the steps."""
    import torch
    import torch.distributed as dist

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import set_mesh

    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree, stats = mae_tree(cfg, seed=0)
    views, noise = train_inputs(cfg)
    trainer = Trainer(tree, stats, "bfloat16", "flash_ring")
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with set_mesh(mesh):
        for i in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            metrics, counts = trainer.run(views, noise[i])
            torch.cuda.synchronize()
            steps.append({"metrics": metrics, "counts": counts, "wall_s": time.perf_counter() - t0})
            if i == 0:
                errs = step_rel_errs(metrics, reference["metrics"], {n: g.cpu() for n, g in trainer.grads().items()},
                                     {n: torch.from_numpy(g) for n, g in reference["grads"].items()})
    flat = torch.cat([p.detach().flatten() for p in trainer.model.parameters()]).cpu()
    first = flat.clone()
    dist.broadcast(first, src=mesh.ranks["model"][0], group=mesh.groups["model"])
    return {"steps": steps, "errs": errs, "params_max_diff": float((flat - first).abs().max()),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def rank_mesh():
    """A rank of phase 7: the one card, f32 kept f32, and the (1, 4) mesh."""
    import torch

    from vit_ae_plus_plus_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return make_mesh(1, GROUP_RANKS)


def group_rank(rank: int, reference: dict) -> dict:
    """Phase 7: one rank's program in the 4-rank gloo world, all ranks on
    the one card (the kernels were built by the parent). -> its numbers."""
    mesh = rank_mesh()
    return {"attention": group_attention(mesh), "vit": group_vit(mesh), "train": group_train(mesh, reference)}


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


def group_phase(rows: list, reference: dict) -> None:
    """Phase 7: run `group_rank` on 4 spawned ranks and hold their numbers
    to the limits; fills the ring rows' `launches` from rank 0's runs."""
    import torch

    from vit_ae_plus_plus_torch.models import MODEL_ZOO
    from vit_ae_plus_plus_torch.parallel import padded_len

    gc.collect()
    torch.cuda.empty_cache()
    results = run_group(group_rank, reference)
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
    tol = STEP_TOL["bfloat16"]
    run_counts = Counter()
    for rank, res in enumerate(results):
        t = res["train"]
        print(f"group rank {rank} train bf16 flash_ring vs the default step, step 1 relative errors: "
              + ", ".join(f"{k} {v:.3g}" for k, v in t["errs"].items())
              + f" (tol loss terms {tol['loss']}, grads {tol['grad']}); losses "
              + ", ".join(f"{s['metrics']['loss']:.6f}" for s in t["steps"])
              + f"; step wall " + ", ".join(f"{s['wall_s']:.2f}" for s in t["steps"])
              + f" s; peak {t['peak_gib']:.2f} GiB; parameters' largest difference from rank 0 after "
              f"{TRAIN_STEPS} steps: {t['params_max_diff']:.3g}", flush=True)
        for k, v in t["errs"].items():
            check(v <= (tol["grad"] if k in GRAD_NAMES else tol["loss"]), f"rank {rank} flash_ring train {k}: {v:.3g}")
        # the replicated trunk is right only while every rank holds the same weights
        check(t["params_max_diff"] == 0.0, f"rank {rank}: parameters differ from rank 0's by "
              f"{t['params_max_diff']:.3g} after {TRAIN_STEPS} flash_ring steps")
        for i, step in enumerate(t["steps"]):
            check(step["counts"] == per_step, f"rank {rank} flash_ring step {i + 1} launched {step['counts']} "
                  f"(want {per_step})")
            if rank == 0:
                run_counts.update(step["counts"])
    fill_launches(rows, run_counts, f"make_train_step, attn_impl='flash_ring', {TRAIN_STEPS} steps, rank 0 of "
                  f"{GROUP_RANKS}")


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
    ]
    rows += [case(label, layout, *shape, dtype, seed=10 + i)
             for i, (case, label, layout, shape, dtype) in enumerate(train_cases)]
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

    # phase 5: the pretraining step at full width (5b: ln_fusion="on")
    t0 = time.perf_counter()
    reference = train_phase(rows)
    print(f"train phase {time.perf_counter() - t0:.1f}s", flush=True)
    fused_layernorm_run(rows, cfg)

    # phase 6: the ring's partial kernels at the ring blocks of phase 7 (the
    # feature path's, the step's decoder's and encoder's), a fully padded
    # block, and the sequence-sharded shard of 1,032 rows against 4,097 keys
    for i, (label, b, h, n, d) in enumerate(ring_shapes(cfg)):
        rows += ring_case(label, b, h, n, d, GROUP_RANKS, seed=70 + i)
    rows += ring_case("ring bf16 NB1032 d64, every key padded", 2, 12, 4097, 64, GROUP_RANKS, seed=75,
                      full_pad=True)
    rows += seq_case("seq bf16 N1032 Nk4097 d64", 2, 12, 4097, 64, GROUP_RANKS, seed=80)

    # with --parent: the redesigned rows in turns against the parent's bodies
    if parent is not None:
        in_turns_phase(rows, cfg, parent, parent_build)

    # phase 7: the sequence-parallel paths in a group of ranks on the card
    group_phase(rows, reference)
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
