#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each of which ends the run with a
non-zero exit when it fails:

1. print the card and build the CUDA kernels from the repository's sources;
2. hold every kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and time kernel, plain version and
   `torch.nn.functional.scaled_dot_product_attention` (a yardstick the port
   never calls) with CUDA events;
3. build the ViT-B feature engine at full width (96^3, patch 8, batch 8,
   bf16) from seeded numpy weights passed through `params_from_jax`, and
   hold its features to the same weights run with `attn_impl="plain"`;
4. serve it over HTTP on an ephemeral port: a correctness check of the
   main path, not a load test. 24 concurrent `POST /features` requests of
   1-3 volumes from 8 clients, each checked against `engine.infer`, with
   launch counts read around this run (12 packed-kernel launches per slab);
   the request rate and p50 are printed as information only. Then the
   per-head kernel's path (`attn_impl="flash"`) and the f32 path, each with
   counts reset before and read after;
5. print one JSON line of kernels, the card's name and power limit, and as
   the last line `{"ok": true, "device": {...}}`.

Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MODEL = "contr_mae_vit_base_patch16"
VOLUME, PATCH, BATCH = 96, 8, 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; f32 without tensor cores
KERNEL_SOURCE = "vit_ae_plus_plus_torch/kernels/csrc/flash_fwd.cu"
REPLACES = {
    "packed": "vit_ae_plus_plus_tpu/kernels/packed_flash.py:164",
    "per_head": "vit_ae_plus_plus_tpu/kernels/pallas_flash.py:446",
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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
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


def bound(b: int, h: int, n: int, d: int, dtype: str, elt: int):
    """Least time the card could take: q, k, v read once and o written once,
    or 4*B*H*N^2*d operations at the type's peak, whichever is larger."""
    t_bytes = 4 * b * n * h * d * elt / HBM_BYTES_PER_S
    t_ops = 4 * b * h * n * n * d / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def kernel_case(label, layout, b, h, n, d, dtype_name, seed):
    """Phase 2 for one shape: error against the plain version, and times."""
    import torch
    import torch.nn.functional as F

    from vit_ae_plus_plus_torch.kernels import (
        attention_plain, flash_attention, kernel_tolerance, packed_attention_plain,
        packed_flash_attention,
    )

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scale = d**-0.5
    if layout == "packed":
        qkv = torch.randn((b, n, 3 * h * d), generator=gen, device="cuda").to(dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        kernel = lambda: packed_flash_attention(qkv, d, scale)  # noqa: E731
        plain = lambda: packed_attention_plain(qkv, d, scale)  # noqa: E731
        o, lse = packed_flash_attention(qkv, d, scale, return_lse=True)
        want_o, want_lse = packed_attention_plain(qkv, d, scale, return_lse=True)
    else:
        q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
        kernel = lambda: flash_attention(q, k, v, scale)  # noqa: E731
        plain = lambda: attention_plain(q, k, v, scale)  # noqa: E731
        o, lse = flash_attention(q, k, v, scale, return_lse=True)
        want_o, want_lse = attention_plain(q, k, v, scale, return_lse=True)
    torch.cuda.synchronize()
    err = (o.float() - want_o.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    tol, lse_tol = kernel_tolerance(want_o)
    check(bool(torch.isfinite(o).all()), f"{label}: non-finite output")
    check(err <= tol and lse_err <= lse_tol,
          f"{label}: max abs err {err:.3g} (tol {tol:.3g}), lse {lse_err:.3g} (tol {lse_tol:.3g})")
    del o, lse, want_o, want_lse
    ms = cuda_ms(kernel, reps=10)
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), reps=10)
    bound_ms, bound_by = bound(b, h, n, d, dtype_name, torch.empty((), dtype=dtype).element_size())
    torch.cuda.empty_cache()
    print(f"kernel {label}: max_abs_err {err:.3g} (tol {tol:.3g}), lse {lse_err:.3g} (tol {lse_tol:.3g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return {
        "name": "packed_flash_fwd" if layout == "packed" else "flash_fwd",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[layout],
        "shape": f"B={b} H={h} N={n} d={d}", "dtype": dtype_name,
        "launches": None, "max_abs_err": err, "tol": tol, "lse_err": lse_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def mae_encoder_tree(cfg, seed: int) -> dict:
    """Seeded numpy weights in the JAX package's MAE param-tree layout (the
    encoder's leaves: the only ones the feature graft reads)."""
    rng = np.random.default_rng(seed)
    d, hidden = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)

    def dense(fan_in, fan_out):  # xavier-uniform kernel, as the JAX init
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return {"kernel": rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(fan_out)).astype(np.float32)}

    def ln():
        return {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(d)).astype(np.float32)}

    tree = {
        "patch_embed": {"proj": dense(cfg.patch_size**3 * cfg.in_chans, d)},
        "cls_token": (0.02 * rng.standard_normal((1, 1, d))).astype(np.float32),
        "norm": ln(),
    }
    for i in range(cfg.depth):
        tree[f"blocks_{i}"] = {
            "norm1": ln(), "norm2": ln(),
            "attn": {"qkv": dense(d, 3 * d), "proj": dense(d, d)},
            "mlp": {"Dense_0": dense(d, hidden), "Dense_1": dense(hidden, d)},
        }
    return tree


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
    from vit_ae_plus_plus_torch.kernels import flash_attention, packed_flash_attention
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
        packed_flash_attention.launches = 0
        flash_attention.launches = 0
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"packed": packed_flash_attention.launches, "per_head": flash_attention.launches}
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
    check(launches["packed"] == 12 * slabs,
          f"packed kernel launched {launches['packed']} times for {slabs} slabs (want 12 per slab)")
    check(launches["per_head"] == 0, "the per-head kernel ran on the packed path")
    latencies = sorted(r[2] for r in results)
    summary = {
        "requests": len(sizes), "volumes": sum(sizes), "slabs": slabs,
        "packed_launches": launches["packed"], "served_vs_infer_rel_err": served_err,
    }
    print(f"serve: {json.dumps(summary)}", flush=True)
    print(f"serve, information only (a {wall:.2f} s burst, not a load test): "
          f"{sum(sizes) / wall:.1f} volumes/s, client p50 {1e3 * latencies[len(latencies) // 2]:.1f} ms, "
          f"server p50 {stats['latency_p50_ms']:.1f} ms, mean batch fill {stats['mean_batch_fill']:.2f}",
          flush=True)
    return summary


def path_launches(engine, vols) -> dict:
    """Run one slab through `engine` with the counts reset just before."""
    from vit_ae_plus_plus_torch.kernels import flash_attention, packed_flash_attention

    packed_flash_attention.launches = 0
    flash_attention.launches = 0
    feats = engine.infer(vols)
    return {"packed": packed_flash_attention.launches, "per_head": flash_attention.launches,
            "feats": feats}


def slab_ms(engine, vols, reps: int = 5) -> float:
    import torch

    engine.infer(vols)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.infer(vols)
    return (time.perf_counter() - t0) / reps * 1e3


def main() -> int:
    import torch

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

    # phase 1: build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
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

    # phase 3: the full-width ViT-B feature engine, kernel against plain
    cfg = MODEL_ZOO[MODEL](volume_size=VOLUME, patch_size=PATCH)
    tree = mae_encoder_tree(cfg, seed=0)
    common = dict(model_name=MODEL, volume_size=VOLUME, patch_size=PATCH, batch_size=BATCH)
    engine = FeatureEngine(mae_params=tree, **common)
    plain = FeatureEngine(mae_params=tree, attn_impl="plain", **common)
    t0 = time.perf_counter()
    engine.warmup()
    print(f"engine warm in {time.perf_counter() - t0:.1f}s", flush=True)
    vols = np.random.default_rng(5).standard_normal((BATCH, 1, VOLUME, VOLUME, VOLUME)).astype(np.float32)
    main_run = path_launches(engine, vols)
    feats, ref = main_run["feats"], plain.infer(vols)
    check(feats.shape == (BATCH, cfg.embed_dim) and bool(np.isfinite(feats).all()), "engine features")
    check(main_run["packed"] == 12 and main_run["per_head"] == 0,
          f"one slab launched packed {main_run['packed']}, per-head {main_run['per_head']} (want 12, 0)")
    err = rel_err(feats, ref)
    print(f"engine bf16: features vs attn_impl=plain rel err {err:.3g} (tol {ENGINE_TOL['bfloat16']})")
    check(err <= ENGINE_TOL["bfloat16"], f"engine features vs plain: rel err {err:.3g}")

    # phase 4: the main path, served over HTTP
    rows[0]["launches"] = serve_phase(engine)["packed_launches"]

    # the per-head kernel's path and the f32 path, counts read around each
    flash = FeatureEngine(mae_params=tree, attn_impl="flash", **common)
    flash_run = path_launches(flash, vols)
    check(flash_run["per_head"] == 12 and flash_run["packed"] == 0,
          f"flash path launched per-head {flash_run['per_head']}, packed {flash_run['packed']}")
    err_flash = rel_err(flash_run["feats"], ref)
    same = float(np.abs(flash_run["feats"] - feats).max())
    print(f"engine bf16 attn_impl=flash: rel err vs plain {err_flash:.3g}, max diff vs packed {same:.3g}")
    check(err_flash <= ENGINE_TOL["bfloat16"], f"flash engine vs plain: rel err {err_flash:.3g}")
    for row in rows[1:4]:
        row["launches"] = flash_run["per_head"]
        row["path"] = "FeatureEngine(attn_impl='flash').infer, one slab"
    rows[0]["path"] = "serve: POST /features through BatchingQueue (attn_impl='auto')"

    f32 = FeatureEngine(mae_params=tree, compute_dtype="float32", **common)
    f32_plain = FeatureEngine(mae_params=tree, compute_dtype="float32", attn_impl="plain", **common)
    f32_run = path_launches(f32, vols)
    check(f32_run["packed"] == 12, f"f32 path launched packed {f32_run['packed']}")
    err32 = rel_err(f32_run["feats"], f32_plain.infer(vols))
    print(f"engine f32: features vs attn_impl=plain rel err {err32:.3g} (tol {ENGINE_TOL['float32']}); "
          f"bf16 vs f32 features rel err {rel_err(feats, f32_run['feats']):.3g}")
    check(err32 <= ENGINE_TOL["float32"], f"f32 engine vs plain: rel err {err32:.3g}")
    rows[4]["launches"] = f32_run["packed"]
    rows[4]["path"] = "FeatureEngine(compute_dtype='float32').infer, one slab"

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
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
