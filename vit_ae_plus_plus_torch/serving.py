"""Serving: a dynamic-batching inference server over the port's ViT.

Counterpart of the JAX package's serving.py:

- `FeatureEngine`: MAE weights -> the ViT encoder on the card, run on
  fixed-size slabs of `batch_size` volumes (the last slab padded with
  repeats), in the compute dtype or on the int8 engine (models/quant.py).
  Requests reach the device through pinned host memory; a call's slabs are
  gathered with one synchronising copy back.
- `ClassifierEngine`: one or more fine-tuned classifier checkpoints (a
  k-fold ensemble) -> the fold-mean softmax, every fold's weights through
  one module in one slab step.
- `BatchingQueue`: gathers concurrent requests into slabs within a bounded
  wait, with admission control and latency/fill statistics.
- `make_http_server` / `serve`: a stdlib ThreadingHTTPServer front end —
  `POST /features` and `POST /predict` with a `.npy` or NIfTI-1 body,
  `GET /healthz`, `GET /stats` — exposed as the `serve` subcommand of
  cli.py; drains on SIGTERM.

With `resize`, a request whose spatial size is not the model's is resampled
on the engine's device (`ops.resize_trilinear`, the weights of
`jax.image.resize`) before it is queued.

The serving mesh (`mesh=`, the CLI's `serve --n-devices N`): JAX splits
each slab over the devices of its 'data' axis in one program; here every
rank of a (D, 1) `parallel.make_mesh` builds the same engine, and the
'data' group's first rank owns the front (the queue, normalisation and
resizing). For each slab it sends the others a slab message, scatters the
slab's rows (`parallel.scatter_batch`: rank d runs rows [d B/D, (d + 1)
B/D) through the same step) and gathers the outputs back
(`all_gather_batch`); the other ranks run `follow()` until
`stop_followers()` sends them the stop message. The last slab is padded
before the split, so every rank gets B/D rows; a batch size that D does
not divide raises `ValueError`, as in JAX. A precompiled engine is a file
of its own (serving_aot.py, the CLI's `compile-engine` and `serve
--engine`).
"""

from __future__ import annotations

import io
import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.models.quant import QuantizedViT
from vit_ae_plus_plus_torch.ops import resize_trilinear
from vit_ae_plus_plus_torch.parallel.mesh import all_gather_batch, broadcast_from, scatter_batch
from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, params_from_jax
from vit_ae_plus_plus_torch.train.step import feature_step
from vit_ae_plus_plus_torch.utils.nifti import is_nifti, read_nifti

QUANTIZE = ("none", "int8")
# the messages of a serving mesh's first rank to the others (`follow`)
_STOP, _SLAB = 0, 1


def _check_options(normalize: str, quantize: str) -> None:
    if normalize not in ("none", "zscore"):
        raise ValueError(f"normalize must be 'none'|'zscore', got {normalize!r}")
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize must be 'none'|'int8', got {quantize!r}")


def _check_mesh(mesh, batch_size: int) -> None:
    """A serving mesh is a (D, 1) data mesh whose 'data' axis divides the
    slab, as JAX's engines ask."""
    if mesh is None:
        return
    others = {a: mesh.size(a) for a in mesh.shape if a != "data" and mesh.size(a) > 1}
    if others:
        raise ValueError(f"a serving mesh shards slabs over 'data' only (parallel.make_mesh(D)); this one also "
                         f"has {others}")
    n_data = mesh.size("data")
    if batch_size % n_data:
        raise ValueError(f"the mesh's data axis ({n_data}) must divide the serving batch_size ({batch_size})")


class _SlabEngine:
    """Fixed-shape slab machinery: per-channel z-score, padding every request
    to `batch_size`, one slab stream on the device at a time, the optional
    resize of mismatched volumes, and the serving mesh's transport (module
    docstring). Subclasses set `_step`, `batch_size`, `volume_shape`,
    `normalize`, `resize`, `device`, `_lock` and, on a mesh, `mesh`."""

    mesh = None

    def _normalize(self, v: np.ndarray) -> np.ndarray:
        if self.normalize == "zscore":
            # per-channel z-score over the spatial dims (the datasets' semantics)
            mean = v.mean(axis=(-3, -2, -1), keepdims=True)
            std = v.std(axis=(-3, -2, -1), keepdims=True)
            v = (v - mean) / np.maximum(std, 1e-8)
        return v

    def _maybe_resize(self, v: np.ndarray) -> np.ndarray:
        """(N, C, ...) -> (N, *volume_shape): with `resize`, mismatched
        spatial sizes are resampled trilinearly on the engine's device, as
        the JAX package's `jax.image.resize`; the channel count must match."""
        if v.shape[1:] == self.volume_shape or not self.resize:
            return v
        if v.ndim != len(self.volume_shape) + 1:
            raise ValueError(f"expected (N, C, D, H, W) volumes, got {v.shape}")
        if v.shape[1] != self.volume_shape[0]:
            raise ValueError(
                f"channel mismatch: model expects {self.volume_shape[0]}, "
                f"got {v.shape[1]} (resize only fixes spatial dims)"
            )
        out = resize_trilinear(torch.from_numpy(v).to(self.device), (v.shape[0], *self.volume_shape))
        return out.cpu().numpy()

    def prepare_one(self, volume: np.ndarray) -> np.ndarray:
        """Validate (and with `resize`, resample) ONE request volume before
        it is queued, so a bad request fails alone instead of poisoning its
        co-batched slab, and requests of mixed sizes share a slab."""
        v = self._maybe_resize(np.asarray(volume, np.float32)[None])[0]
        if v.shape != self.volume_shape:
            raise ValueError(
                f"expected ({', '.join(map(str, self.volume_shape))}), got {v.shape}"
            )
        return v

    def warmup(self) -> float:
        """Run one slab (building the kernels on first use); returns seconds."""
        t0 = time.perf_counter()
        self.infer(np.zeros((self.batch_size, *self.volume_shape), np.float32))
        return time.perf_counter() - t0

    def infer(self, volumes: np.ndarray) -> np.ndarray:
        """(N, C, S, S, S) -> (N, out_dim) float32, any N >= 1."""
        volumes = self._maybe_resize(np.asarray(volumes, np.float32))
        if volumes.ndim != 5 or volumes.shape[1:] != self.volume_shape:
            raise ValueError(
                f"expected (N, {', '.join(map(str, self.volume_shape))}), "
                f"got {volumes.shape}"
            )
        volumes = self._normalize(volumes)
        n, b = volumes.shape[0], self.batch_size
        n_pad = -(-n // b) * b
        host = torch.empty(
            (n_pad, *self.volume_shape), dtype=torch.float32,
            pin_memory=self.device.type == "cuda",
        )
        host[:n] = torch.from_numpy(volumes)
        host[n:] = host[(n - 1) // b * b]  # pad the last slab with its first volume
        with self._lock:
            # enqueue every slab (copy, then compute, on one stream), then
            # one synchronising copy of all features back to the host
            outs = [self._run_slab(host[i:i + b]) for i in range(0, n_pad, b)]
            feats = torch.cat(outs)[:n].float().cpu()
        return feats.numpy()

    def _run_slab(self, slab: torch.Tensor) -> torch.Tensor:
        """The outputs of one slab `slab` (B, ...) in host memory, on the
        device; on a mesh, the followers are sent the slab message and each
        rank runs its rows."""
        if self.mesh is None or self.mesh.size("data") == 1:
            return self._step(slab.to(self.device, non_blocking=True))
        self._message(_SLAB)
        return self._mesh_rows(slab)

    def _mesh_rows(self, slab: Optional[torch.Tensor]) -> torch.Tensor:
        """This rank's rows of the first rank's `slab` (None elsewhere)
        through the step, the 'data' group's outputs gathered in row order."""
        rows = scatter_batch(slab, self.mesh, (self.batch_size, *self.volume_shape), torch.float32, self.device)
        return all_gather_batch(self._step(rows), self.mesh, "data")

    def _message(self, op: Optional[int] = None) -> int:
        """The first rank's `op` on every rank of the 'data' group."""
        t = torch.tensor([_STOP if op is None else op], dtype=torch.int64, device=self.device)
        return int(broadcast_from(t, self.mesh, "data", 0).item())

    def follow(self) -> int:
        """A follower rank of a serving mesh: run its rows of every slab the
        first rank sends until the stop message. -> the slabs it ran."""
        if self.mesh is None or self.mesh.coords["data"] == 0:
            raise RuntimeError("follow() runs on the ranks of a serving mesh other than its first")
        slabs = 0
        while self._message() == _SLAB:
            self._mesh_rows(None)
            slabs += 1
        return slabs

    def stop_followers(self) -> None:
        """On the first rank of a serving mesh: end the others' `follow`
        (nothing without a mesh)."""
        if self.mesh is not None and self.mesh.size("data") > 1 and self.mesh.coords["data"] == 0:
            with self._lock:
                self._message(_STOP)


class FeatureEngine(_SlabEngine):
    """MAE weights -> the ViT encoder's `forward_features` on fixed slabs.

    Weights come from `checkpoint_path` (a reference-layout `.pth`, as the
    JAX package's `export-torch` writes it) or from `mae_params` (a JAX MAE
    param tree of numpy arrays). `quantize="int8"` runs the int8 engine
    (models/quant.py) over the grafted weights, quantised once here.
    `device` defaults to `cuda` and raises when there is none; pass
    `device="cpu"` to run on the CPU. `mesh`: a (D, 1) `parallel.make_mesh`
    to serve over (module docstring); D must divide `batch_size`."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        model_name: str = "contr_mae_vit_base_patch16",
        volume_size: int = 96,
        in_chans: int = 1,
        patch_size: int = 8,
        batch_size: int = 8,
        compute_dtype: str = "bfloat16",
        normalize: str = "none",
        mae_params: Optional[Dict] = None,
        attn_impl: str = "auto",
        quantize: str = "none",
        resize: bool = False,
        device=None,
        mesh=None,
    ):
        _check_options(normalize, quantize)
        _check_mesh(mesh, batch_size)
        self.device = resolve_device(device)
        mae_cfg = MODEL_ZOO[model_name](
            volume_size=volume_size, in_chans=in_chans, patch_size=patch_size,
            dtype=compute_dtype, attn_impl=attn_impl,
        )
        # num_classes=2 as in the extraction graft (the fresh-keys check
        # expects a head; forward_features ignores it)
        vit_cfg = mae_cfg.encoder_vit_config(num_classes=2, global_pool=True)
        if mae_params is not None:
            mae_sd = params_from_jax(mae_params, patch_size, in_chans)
        elif checkpoint_path is not None:
            mae_sd = load_reference_state_dict(checkpoint_path)
        else:
            raise ValueError("need checkpoint_path or mae_params")
        self.model = build_grafted_vit(mae_sd, mae_cfg, vit_cfg, self.device).eval()
        if quantize == "int8":
            self.model = QuantizedViT(self.model.state_dict(), vit_cfg)
        self._step = lambda batch: feature_step(self.model, batch)

        self.config = dict(model_name=model_name, volume_size=volume_size, in_chans=in_chans,
                           patch_size=patch_size, compute_dtype=compute_dtype, attn_impl=attn_impl)
        self.mesh = mesh
        self.quantize = quantize
        self.batch_size = int(batch_size)
        self.volume_shape = (in_chans, volume_size, volume_size, volume_size)
        self.normalize = normalize
        self.resize = resize
        self.feature_dim = mae_cfg.embed_dim
        self._lock = threading.Lock()  # one caller's slabs at a time


class ClassifierEngine(_SlabEngine):
    """Fine-tuned classifier serving, one checkpoint or a k-fold ensemble:
    the fold-mean softmax in f32, computed inside one slab step.

    Weights: `checkpoint_paths` (one `.pth` or a list; the reference-layout
    classifier state dicts that `finetune-kfold` and `finetune` write) or
    `vit_params_list` (JAX ViT param trees of numpy arrays). The
    `VisionTransformer3D(num_classes, global_pool=True)` is built once and
    every fold's weights run through it (`torch.func.functional_call`).
    `quantize="int8"`: each fold's trunk on the int8 engine, its head and
    softmax in f32. `device` and `mesh` as `FeatureEngine`'s."""

    def __init__(
        self,
        checkpoint_paths=None,
        model_name: str = "contr_mae_vit_base_patch16",
        volume_size: int = 96,
        in_chans: int = 1,
        patch_size: int = 8,
        batch_size: int = 8,
        num_classes: int = 2,
        compute_dtype: str = "bfloat16",
        quantize: str = "none",
        normalize: str = "none",
        vit_params_list: Optional[List[Dict]] = None,
        resize: bool = False,
        attn_impl: str = "auto",
        device=None,
        mesh=None,
    ):
        _check_options(normalize, quantize)
        _check_mesh(mesh, batch_size)
        self.device = resolve_device(device)
        if isinstance(checkpoint_paths, str):
            checkpoint_paths = [checkpoint_paths]
        mae_cfg = MODEL_ZOO[model_name](
            volume_size=volume_size, in_chans=in_chans, patch_size=patch_size,
            dtype=compute_dtype, attn_impl=attn_impl,
        )
        vit_cfg = mae_cfg.encoder_vit_config(num_classes=num_classes, global_pool=True)
        if vit_params_list is not None:
            sds = [params_from_jax(tree, patch_size, in_chans) for tree in vit_params_list]
        elif checkpoint_paths:
            sds = [load_reference_state_dict(path) for path in checkpoint_paths]
        else:
            raise ValueError("need checkpoint_paths or vit_params_list")
        with torch.device("meta"):
            model = build_model(vit_cfg)
        model = model.to_empty(device=self.device).eval()
        folds = []
        for sd in sds:
            model.load_state_dict(sd, strict=True)  # every fold's keys and shapes
            # contiguous, as a loaded state dict's (params_from_jax's kernels are transposed views)
            fold = {k: v.to(self.device).contiguous() for k, v in sd.items()}
            folds.append(QuantizedViT(fold, vit_cfg) if quantize == "int8" else fold)
        self.model, self.folds = model, folds
        self._step = ensemble_step(model, folds)

        self.config = dict(model_name=model_name, volume_size=volume_size, in_chans=in_chans,
                           patch_size=patch_size, compute_dtype=compute_dtype, attn_impl=attn_impl)
        self.mesh = mesh
        self.quantize = quantize
        self.batch_size = int(batch_size)
        self.volume_shape = (in_chans, volume_size, volume_size, volume_size)
        self.normalize = normalize
        self.resize = resize
        self.num_classes = num_classes
        self.num_folds = len(folds)
        self._lock = threading.Lock()

    @classmethod
    def from_work_dir(cls, work_dir: str, criterion: str = "ft", **kwargs) -> "ClassifierEngine":
        """The ensemble of a `finetune-kfold` work dir: its per-fold best
        checkpoints `checkpoints/checkpoint-best_{criterion}_model_{k}.pth`,
        in fold order (other files beside them, such as an unfinished
        write's temporary file, are skipped), or `finetune`'s single
        `checkpoint-best_{criterion}_model.pth`. `criterion`: 'ft' (ROC AUC),
        'spec' or 'sens'. The JAX package reads orbax directories of the
        same names, without the suffix."""
        ckpt_dir = os.path.join(work_dir, "checkpoints")
        stem = f"checkpoint-best_{criterion}_model"
        folds = []
        for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else ():
            m = re.fullmatch(re.escape(stem) + r"_(\d+)\.pth", name)
            if m:
                folds.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
        paths = [p for _, p in sorted(folds)]
        single = os.path.join(ckpt_dir, stem + ".pth")
        if not paths and os.path.isfile(single):
            paths = [single]
        if not paths:
            raise FileNotFoundError(f"no checkpoints {stem}_<fold>.pth or {stem}.pth in {ckpt_dir}")
        return cls(paths, **kwargs)


def ensemble_step(model: torch.nn.Module, folds: list):
    """The slab step of a fold ensemble: each fold's softmax in f32 (a
    `QuantizedViT`, or a state dict run through `model` by
    `torch.func.functional_call`), averaged over the folds."""

    def probs(fold, batch):
        with torch.inference_mode():
            if isinstance(fold, QuantizedViT):
                logits = fold(batch)
            else:
                logits = torch.func.functional_call(model, fold, (batch,))
            return torch.softmax(logits.float(), dim=-1)

    return lambda batch: sum(probs(fold, batch) for fold in folds) / len(folds)


class QueueFull(RuntimeError):
    """Raised by BatchingQueue.submit when admission is at max_depth —
    mapped to HTTP 429 by the server front."""


class _BodyTooLarge(RuntimeError):
    """Request body over the server's max_body_mb — mapped to HTTP 413."""


class _Pending:
    __slots__ = ("volume", "event", "result", "error", "t_submit")

    def __init__(self, volume):
        self.volume = volume
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.time()


class BatchingQueue:
    """Dynamic batcher: gathers concurrent requests into engine-sized slabs.

    The worker blocks for the first request, then drains up to
    ``batch_size - 1`` more within ``max_wait_ms`` before running one padded
    slab — bounded added latency, full slabs under load."""

    def __init__(self, engine: _SlabEngine, max_wait_ms: float = 5.0,
                 max_history: int = 1024, max_depth: Optional[int] = None):
        """`max_depth`: bounded admission (load shedding) — submit() raises
        QueueFull once this many requests are waiting. Default: 32 slabs'
        worth of requests."""
        self.engine = engine
        self.max_wait_s = max_wait_ms / 1e3
        self.max_depth = max_depth if max_depth is not None else 32 * engine.batch_size
        self._queue: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._latencies: deque = deque(maxlen=max_history)
        self._fills: deque = deque(maxlen=max_history)
        # guards the history deques: the worker appends outside _cv while
        # stats() iterates them
        self._stats_lock = threading.Lock()
        self._total_requests = 0
        self._total_batches = 0
        self._total_shed = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, volume: np.ndarray) -> _Pending:
        return self.submit_many([volume])[0]

    def submit_many(self, volumes) -> list:
        """Atomically admit a whole request's volumes — all or QueueFull.
        Validation runs in the CALLER's thread so a malformed request raises
        alone, never failing co-batched requests."""
        pendings = [_Pending(self.engine.prepare_one(v)) for v in volumes]
        with self._cv:
            if self._closed:
                raise RuntimeError("queue is closed")
            if len(self._queue) + len(pendings) > self.max_depth:
                self._total_shed += len(pendings)
                raise QueueFull(
                    f"serving queue at capacity ({len(self._queue)} waiting, "
                    f"request of {len(pendings)} > {self.max_depth} limit)"
                )
            self._queue.extend(pendings)
            self._total_requests += len(pendings)
            self._cv.notify()
        return pendings

    def infer_one(self, volume: np.ndarray, timeout: float = 120.0) -> np.ndarray:
        pending = self.submit(volume)
        if not pending.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def _drain(self):
        """One slab's worth of requests (called with the lock held)."""
        batch = [self._queue.popleft()]
        deadline = time.time() + self.max_wait_s
        while len(batch) < self.engine.batch_size:
            remaining = deadline - time.time()
            if self._queue:
                batch.append(self._queue.popleft())
            elif remaining > 0 and not self._closed:
                self._cv.wait(remaining)
            else:
                break
        return batch

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                batch = self._drain()
            try:
                feats = self.engine.infer(np.stack([p.volume for p in batch]))
                now = time.time()
                for p, f in zip(batch, feats):
                    p.result = f
                # record the batch's stats BEFORE waking any client, so a
                # caller reading stats() right after its answer sees its sample
                with self._stats_lock:
                    for p in batch:
                        self._latencies.append(now - p.t_submit)
                    self._fills.append(len(batch) / self.engine.batch_size)
                    self._total_batches += 1
                for p in batch:
                    p.event.set()
            except BaseException as e:  # deliver, don't kill the worker
                for p in batch:
                    p.error = e
                    p.event.set()

    def reset_stats(self) -> None:
        """Clear the latency and fill history, keeping the counters: a
        benchmark drops its warm-up samples before it reads percentiles."""
        with self._stats_lock:
            self._latencies.clear()
            self._fills.clear()

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            fills = list(self._fills)
            batches = self._total_batches
        pct = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))] if lat else 0.0  # noqa: E731
        return {
            "total_requests": self._total_requests,
            "total_batches": batches,
            "total_shed": self._total_shed,
            "queue_depth": len(self._queue),
            "mean_batch_fill": float(np.mean(fills)) if fills else 0.0,
            "latency_p50_ms": round(pct(0.50) * 1e3, 3),
            "latency_p95_ms": round(pct(0.95) * 1e3, 3),
            "batch_size": self.engine.batch_size,
        }

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=10)


def make_http_server(queue: Optional[BatchingQueue] = None, host: str = "127.0.0.1",
                     port: int = 8000, classifier_queue: Optional[BatchingQueue] = None,
                     max_body_mb: int = 1024):
    """ThreadingHTTPServer over BatchingQueues of a FeatureEngine (`queue`)
    and of a ClassifierEngine (`classifier_queue`), either or both.

    POST /features — body, sent with a Content-Length: ``.npy`` bytes of one
    (C,S,S,S) volume or an (N,C,S,S,S) stack, or a NIfTI-1 file (``.nii`` or
    ``.nii.gz``; a 3-D volume is one channel, a 4-D one's last axis the
    channels); response: ``.npy`` bytes of (N,D) float32 features.
    POST /predict — the same bodies; response: JSON {probs, pred, num_folds}.
    GET /healthz — liveness; GET /stats — batching statistics JSON, nested
    under "features" and "predict" when both queues are served.
    Failure codes: 400 malformed request (a body neither .npy nor NIfTI-1),
    404 unknown path or a task not served, 411 body without Content-Length
    (e.g. chunked), 413 body over `max_body_mb`, 429 queue at capacity
    (retry later), 500 server-side inference error, 504 inference timeout."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if max_body_mb < 1:
        raise ValueError(f"max_body_mb must be >= 1, got {max_body_mb}")

    class _Server(ThreadingHTTPServer):
        # join handler threads on server_close(): a SIGTERM drain lets
        # already-computed responses finish writing
        daemon_threads = False
        block_on_close = True

    def _gather(q: BatchingQueue, arr: np.ndarray) -> np.ndarray:
        # admit the whole stack atomically (all-or-429), then wait
        pendings = q.submit_many(list(arr))
        out = []
        for p in pendings:
            if not p.event.wait(300):
                raise TimeoutError("inference timed out")
            if p.error is not None:
                raise p.error
            out.append(p.result)
        return np.stack(out)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default; /stats has the numbers
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/stats":
                stats = {name: q.stats() for name, q in (("features", queue), ("predict", classifier_queue))
                         if q is not None}
                self._json(200, next(iter(stats.values())) if len(stats) == 1 else stats)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def _drain_body(self, length: int):
            # A rejection answered without reading the body would close a
            # socket with unread data, and the kernel's RST can destroy the
            # response before a still-sending client reads it. Discard the
            # unread remainder (bounded) so the close is graceful; an
            # oversend beyond twice the cap gets the hard close.
            left = length - self._consumed
            if length > 2 * max_body_mb * 2**20:
                return
            try:
                while left > 0:
                    chunk = self.rfile.read(min(left, 1 << 20))
                    if not chunk:
                        break
                    left -= len(chunk)
            except OSError:
                pass

        def _read_volumes(self, length: int, engine) -> np.ndarray:
            if length > max_body_mb * 2**20:
                raise _BodyTooLarge(f"body {length} bytes > max_body_mb={max_body_mb}")
            body = self.rfile.read(length)
            self._consumed = len(body)
            if body[:6] == b"\x93NUMPY":
                arr = np.load(io.BytesIO(body), allow_pickle=False)
            elif is_nifti(body):
                arr = read_nifti(body)
                if arr.ndim == 3:  # (x, y, z) -> one channel
                    arr = arr[None]
                elif arr.ndim == 4:  # (x, y, z, t) -> channels first
                    arr = arr.transpose(3, 0, 1, 2)
                else:
                    raise ValueError(f"NIfTI volume must be 3-D or 4-D, got {arr.ndim}-D")
            else:
                raise ValueError("body is neither .npy nor NIfTI-1")
            if arr.ndim == len(engine.volume_shape):
                arr = arr[None]
            return arr

        def do_POST(self):
            self._consumed = 0
            # a body of unknown length (chunked, or no header) cannot be
            # drained, so its answer could be lost to a reset: refuse it
            # before any processing and close the connection
            if "Content-Length" not in self.headers or "Transfer-Encoding" in self.headers:
                self.close_connection = True
                self._json(411, {"error": "a Content-Length header is required"})
                return
            try:
                length = int(self.headers["Content-Length"])
                if length < 0:
                    raise ValueError(f"negative Content-Length {length}")
            except ValueError as e:
                self.close_connection = True
                self._json(400, {"error": f"bad Content-Length: {e}"})
                return
            try:
                if self.path == "/features" and queue is not None:
                    feats = _gather(queue, self._read_volumes(length, queue.engine))
                    buf = io.BytesIO()
                    np.save(buf, feats.astype(np.float32), allow_pickle=False)
                    body = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/predict" and classifier_queue is not None:
                    engine = classifier_queue.engine
                    probs = _gather(classifier_queue, self._read_volumes(length, engine))
                    self._json(200, {"probs": probs.tolist(), "pred": probs.argmax(-1).tolist(),
                                     "num_folds": engine.num_folds})
                else:
                    self._drain_body(length)  # rejected before the body was read
                    self._json(404, {"error": f"unknown path {self.path}"})
            except QueueFull as e:
                self._json(429, {"error": str(e)})  # shed load, retry later
            except _BodyTooLarge as e:
                self._drain_body(length)
                self._json(413, {"error": str(e)})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})  # server-side: retryable
            except ValueError as e:  # malformed body or shape: client fault
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # device/runtime failure: server fault
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return _Server((host, port), Handler)


def build_engine(
    checkpoint_path: str,
    task: str = "features",
    model_name: str = "contr_mae_vit_base_patch16",
    volume_size: int = 96,
    in_chans: int = 1,
    patch_size: int = 8,
    batch_size: int = 8,
    compute_dtype: str = "bfloat16",
    quantize: str = "none",
    normalize: str = "none",
    num_classes: int = 2,
    ensemble_criterion: str = "ft",
    resize: bool = False,
    device=None,
    mesh=None,
):
    """The engine `serve` runs. 'features': a FeatureEngine over an MAE
    `.pth`. 'classify': a ClassifierEngine over comma-separated `.pth`
    paths, a `finetune-kfold` work dir (its per-fold best
    `ensemble_criterion` checkpoints) or one `.pth`. `mesh`: the serving
    mesh (module docstring)."""
    if checkpoint_path is None:
        raise ValueError("need checkpoint_path")
    common = dict(model_name=model_name, volume_size=volume_size, in_chans=in_chans,
                  patch_size=patch_size, batch_size=batch_size, compute_dtype=compute_dtype,
                  quantize=quantize, normalize=normalize, resize=resize, device=device, mesh=mesh)
    if task == "classify":
        common["num_classes"] = num_classes
        if "," in checkpoint_path:
            return ClassifierEngine(checkpoint_path.split(","), **common)
        if os.path.isdir(os.path.join(checkpoint_path, "checkpoints")):
            return ClassifierEngine.from_work_dir(checkpoint_path, criterion=ensemble_criterion, **common)
        return ClassifierEngine(checkpoint_path, **common)
    if task == "features":
        return FeatureEngine(checkpoint_path, **common)
    raise ValueError(f"task must be 'features'|'classify', got {task!r}")


def serve(
    checkpoint_path: Optional[str] = None,
    model_name: str = "contr_mae_vit_base_patch16",
    volume_size: int = 96,
    in_chans: int = 1,
    patch_size: int = 8,
    batch_size: int = 8,
    compute_dtype: str = "bfloat16",
    quantize: str = "none",
    normalize: str = "none",
    max_wait_ms: float = 5.0,
    host: str = "127.0.0.1",
    port: int = 8000,
    task: str = "features",
    num_classes: int = 2,
    ensemble_criterion: str = "ft",
    resize: bool = False,
    max_body_mb: int = 1024,
    device=None,
    mesh=None,
    engine_path: Optional[str] = None,
):
    """Build the engine (`build_engine`), or load the precompiled one at
    `engine_path` (serving_aot.py `load_engine`; the other engine options
    and `mesh` are then ignored), warm it, and run the HTTP server until
    SIGTERM or Ctrl-C: POST /features for task 'features', POST /predict
    for 'classify'. Accepted requests are answered before it returns. On a
    serving mesh every rank calls it: the 'data' group's first rank serves
    and, when it stops, stops the others, which run their rows of each slab
    until then (module docstring)."""
    if engine_path is not None:
        from vit_ae_plus_plus_torch.serving_aot import load_engine

        engine, mesh = load_engine(engine_path, device=device), None
        task = "classify" if engine.kind == "classify" else "features"
    else:
        engine = build_engine(
            checkpoint_path, task=task, model_name=model_name, volume_size=volume_size,
            in_chans=in_chans, patch_size=patch_size, batch_size=batch_size,
            compute_dtype=compute_dtype, quantize=quantize, normalize=normalize,
            num_classes=num_classes, ensemble_criterion=ensemble_criterion, resize=resize, device=device,
            mesh=mesh,
        )
    if mesh is not None and mesh.coords["data"] != 0:
        engine.follow()
        return
    try:
        t = engine.warmup()
        folds = f", {engine.num_folds}-fold ensemble" if task == "classify" else ""
        ranks = f", {mesh.size('data')} ranks" if mesh is not None else ""
        print(f"engine warm in {t:.1f}s (batch {engine.batch_size}, "
              f"{engine.quantize if engine.quantize != 'none' else engine.config['compute_dtype']}{folds}, "
              f"{engine.device}{ranks})", flush=True)
        _serve_http(engine, task, max_wait_ms, host, port, max_body_mb)
    finally:
        engine.stop_followers()


def _serve_http(engine, task: str, max_wait_ms: float, host: str, port: int, max_body_mb: int) -> None:
    """`serve`'s front: the queue and the HTTP server over `engine` until
    SIGTERM or Ctrl-C, accepted requests answered before it returns."""
    queue = BatchingQueue(engine, max_wait_ms=max_wait_ms)
    kw = {"classifier_queue": queue} if task == "classify" else {"queue": queue}
    server = make_http_server(host=host, port=port, max_body_mb=max_body_mb, **kw)
    endpoint = "POST /predict" if task == "classify" else "POST /features"

    import signal

    def _stop(signum, _frame):
        # shutdown() must come from another thread (serve_forever holds this one)
        print(f"signal {signum}: draining and shutting down", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    # the handler goes in BEFORE the readiness line: a script reading
    # "listening on" may send SIGTERM right after
    prev = signal.signal(signal.SIGTERM, _stop)
    print(f"listening on http://{host}:{server.server_address[1]} "
          f"({endpoint}, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.shutdown()
        queue.close()  # answers already-accepted requests
        server.server_close()  # joins handler threads
        print("server stopped", flush=True)
