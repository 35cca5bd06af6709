"""Precompiled serving engines: an engine written to one file, loaded
without a graft, a quantisation or a kernel build.

Counterpart of the JAX package's serving_aot.py, in a format of its own
(a port artifact is not a JAX `.vitae` file, nor the other way round):

    python -m vit_ae_plus_plus_torch.cli compile-engine --checkpoint mae.pth --out engine.vitae
    python -m vit_ae_plus_plus_torch.cli serve --engine engine.vitae

JAX serialises the compiled XLA executable of the slab step. PyTorch runs
eagerly, so what an engine's build costs here is the graft of the
checkpoint (or the int8 quantisation, or every fold's load) and the nvcc
build of the kernels the step launches. The artifact is a zip of:

    meta.json      the format and its version; the engine's surface (kind,
                   model, batch size, volume shape, normalize, resize,
                   quantize, feature dim or classes and folds, and the
                   config the module is built from); the fingerprint of the
                   build (platform, device name and compute capability,
                   torch and CUDA versions); each kernel library's source
                   digest (`kernels/_build.source_digest`) and the sha256
                   of its file; the weight manifest (name, dtype, shape);
    weights.npz    the engine's resolved tensors in manifest order: the
                   grafted ViT, the int8 engine's quantised weights and
                   scales, or every fold's weights. It loads with
                   allow_pickle=False; bfloat16 is stored as uint16 and
                   viewed back. In a bfloat16 engine every leaf that the
                   model only casts to bfloat16 at its use (all but the
                   LayerNorms', which it takes in f32) is stored in
                   bfloat16, which leaves the slab's arithmetic as it is;
    kernels/*.so   on a `cuda` engine, the sm_90a libraries that its step
                   loaded (`_build.recording`).

`load_engine` builds the module on the `meta` device and assigns the stored
tensors: no `build_grafted_vit`, no quantisation, no random draw, no nvcc.
The shipped libraries are written under their own sha256 and handed to
`_build.use_library`, so every launch takes them and nothing is built.

Trust boundary: meta.json and weights.npz are data, and a swapped payload
can change the answers but runs no code. The kernel libraries are machine
code that the loader maps into the process, as JAX's `executable.bin` is
unpickled: load artifacts only from builds you trust, and check the
file's digest where artifacts cross trust zones.

Refused: by `load_engine` with RuntimeError, another format or version, a
member that is not one of the above, a fingerprint other than the loading
process's, and a kernel library that is missing, whose bytes differ from
its digest, or that was built from other kernel sources than this
checkout's (the wrappers' parameter blocks must match); by `save_engine`
with NotImplementedError, a mesh engine (single-device artifacts only, as
in JAX).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import platform
import re
import threading
import zipfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.kernels import _build
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.models.quant import QuantizedViT
from vit_ae_plus_plus_torch.serving import ClassifierEngine, FeatureEngine, _SlabEngine, ensemble_step
from vit_ae_plus_plus_torch.train.step import feature_step

FORMAT = "vit_ae_plus_plus_torch engine"
FORMAT_VERSION = 1
_META, _WEIGHTS, _KERNELS = "meta.json", "weights.npz", "kernels/"
# the leaves a ViT takes in f32 whatever its compute dtype (models/vit.py `_layer_norm`)
_F32_LEAVES = re.compile(r"(^|\.)(norm1|norm2|norm|fc_norm)\.(weight|bias)$")
_FINGERPRINT = ("platform", "device_name", "capability", "torch", "cuda")


def fingerprint(device) -> dict:
    """What an artifact built on `device` is tied to: the platform, the
    device's name and compute capability (the CPU's machine type), the
    torch version and, on `cuda`, the CUDA version."""
    device = torch.device(device)
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        name, capability = torch.cuda.get_device_name(index), list(torch.cuda.get_device_capability(index))
    else:
        name, capability = platform.machine() or device.type, None
    return {"platform": device.type, "device_name": name, "capability": capability, "torch": torch.__version__,
            "cuda": torch.version.cuda if device.type == "cuda" else None}


def _trees(engine) -> List:
    """The engine's weight trees: one for a FeatureEngine, one a fold for a
    ClassifierEngine; each a state dict or a `QuantizedViT`."""
    if isinstance(engine, FeatureEngine):
        model = engine.model
        return [model if isinstance(model, QuantizedViT) else model.state_dict()]
    return list(engine.folds)


def _resolved(engine) -> Dict[str, torch.Tensor]:
    """{name: tensor} as the artifact stores them: `fold{k}/` before a
    fold's names, `/w8` and `/scale` after a quantised weight's; in a
    bfloat16 engine every leaf but the LayerNorms' in bfloat16."""
    low = engine.quantize == "none" and engine.config["compute_dtype"] == "bfloat16"
    out = {}
    for k, tree in enumerate(_trees(engine)):
        prefix = f"fold{k}/" if isinstance(engine, ClassifierEngine) else ""
        items = tree.params.items() if isinstance(tree, QuantizedViT) else tree.items()
        for name, value in items:
            if isinstance(value, dict):
                out.update({f"{prefix}{name}/{part}": t for part, t in value.items()})
            elif low and value.is_floating_point() and not _F32_LEAVES.search(name):
                out[prefix + name] = value.to(torch.bfloat16)
            else:
                out[prefix + name] = value
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.tensor(a.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(a)  # a copy in torch's own allocation


def _kernel_manifest(engine) -> tuple:
    """On a `cuda` engine, run one slab and record the libraries its step
    loads -> ({name: source digest, member, sha256}, {member: bytes})."""
    if engine.device.type != "cuda":
        return {}, {}
    with _build.recording() as names:
        engine.warmup()
    manifest, files = {}, {}
    for name in sorted(names):
        path = _build.loaded_file(name)
        data = path.read_bytes()
        member = _KERNELS + path.name
        manifest[name] = {"sources": _build.source_digest(name), "library": member,
                          "sha256": hashlib.sha256(data).hexdigest()}
        files[member] = data
    return manifest, files


def save_engine(engine: _SlabEngine, path: str) -> dict:
    """Write `engine` (a FeatureEngine or a ClassifierEngine, built on one
    device) to the artifact `path` (module docstring). -> its meta."""
    if getattr(engine, "mesh", None) is not None:
        raise NotImplementedError("engine artifacts are single-device: a serving mesh's ranks each build "
                                  "their engine from the checkpoint at startup instead")
    if isinstance(engine, FeatureEngine):
        surface = {"kind": "features", "feature_dim": engine.feature_dim}
    elif isinstance(engine, ClassifierEngine):
        surface = {"kind": "classify", "num_classes": engine.num_classes, "num_folds": engine.num_folds}
    else:
        raise TypeError(f"unsupported engine type {type(engine).__name__}")
    kernels, files = _kernel_manifest(engine)
    tensors = _resolved(engine)
    arrays, manifest = {}, []
    for i, (name, t) in enumerate(tensors.items()):
        arrays[f"w{i:05d}"] = _to_numpy(t)
        manifest.append({"name": name, "dtype": str(t.dtype).removeprefix("torch."), "shape": list(t.shape)})
    meta = {"format": FORMAT, "format_version": FORMAT_VERSION, **surface, "config": engine.config,
            "quantize": engine.quantize, "batch_size": engine.batch_size,
            "volume_shape": list(engine.volume_shape), "normalize": engine.normalize, "resize": bool(engine.resize),
            "fingerprint": fingerprint(engine.device), "kernels": kernels, "weights": manifest}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_DEFLATED, allowZip64=True) as zf:
            zf.writestr(_META, json.dumps(meta, indent=1))
            zf.writestr(zipfile.ZipInfo(_WEIGHTS), buf.getvalue(), compress_type=zipfile.ZIP_STORED)
            for member, data in files.items():
                zf.writestr(member, data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta


def _install_kernels(zf: zipfile.ZipFile, meta: dict, path: str) -> Dict[str, Path]:
    """Check each shipped library against its digests and write it under
    its sha256 in the build directory -> {name: file}."""
    out = {}
    for name, lib in meta["kernels"].items():
        try:
            data = zf.read(lib["library"])
        except KeyError:
            raise RuntimeError(f"{path}: the kernel library {lib['library']} of {name} is missing") from None
        digest = hashlib.sha256(data).hexdigest()
        if digest != lib["sha256"]:
            raise RuntimeError(f"{path}: the kernel library {lib['library']} has sha256 {digest}, the artifact "
                               f"records {lib['sha256']}")
        if lib["sources"] != _build.source_digest(name):
            raise RuntimeError(f"{path}: the {name} library was built from other kernel sources than this "
                               "checkout's; rebuild the artifact with compile-engine")
        target = _build.BUILD_DIR / "engines" / digest[:16] / Path(lib["library"]).name
        if not target.is_file() or hashlib.sha256(target.read_bytes()).hexdigest() != digest:
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            tmp.write_bytes(data)
            os.replace(tmp, target)
        out[name] = target
    return out


def load_engine(path: str, device=None) -> "_AOTEngine":
    """The engine of the artifact `path`, ready to serve, on `device` (the
    artifact's platform by default). Raises RuntimeError for what the
    module docstring lists."""
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        try:
            meta = json.loads(zf.read(_META))
        except (KeyError, ValueError) as e:
            raise RuntimeError(f"{path}: not an engine artifact ({e})") from None
        if meta.get("format") != FORMAT or meta.get("format_version") != FORMAT_VERSION:
            raise RuntimeError(f"{path}: unsupported engine format {meta.get('format')!r} version "
                               f"{meta.get('format_version')!r} (this build reads {FORMAT!r} version "
                               f"{FORMAT_VERSION}); rebuild it with compile-engine")
        foreign = [n for n in names if n not in (_META, _WEIGHTS) and not n.startswith(_KERNELS)]
        if foreign:
            raise RuntimeError(f"{path}: unexpected members {foreign}: an artifact holds meta.json, weights.npz "
                               "and kernel libraries only")
        built = meta["fingerprint"]
        device = resolve_device(built["platform"] if device is None else device)
        here = fingerprint(device)
        for key in _FINGERPRINT:
            if built.get(key) != here[key]:
                raise RuntimeError(f"{path}: the engine was built for {key}={built.get(key)!r} but this process "
                                   f"has {here[key]!r}; rebuild it with compile-engine here")
        libraries = _install_kernels(zf, meta, path)
        with np.load(io.BytesIO(zf.read(_WEIGHTS)), allow_pickle=False) as z:
            stored = {k: z[k] for k in z.files}
    if len(stored) != len(meta["weights"]):
        raise RuntimeError(f"{path}: {len(stored)} weight arrays for {len(meta['weights'])} in the manifest")
    tensors = {}
    for i, entry in enumerate(meta["weights"]):
        a = stored[f"w{i:05d}"]
        t = _from_numpy(a, entry["dtype"])
        if str(t.dtype).removeprefix("torch.") != entry["dtype"] or list(t.shape) != entry["shape"]:
            raise RuntimeError(f"{path}: {entry['name']} is {t.dtype} {tuple(t.shape)}, the manifest says "
                               f"{entry['dtype']} {tuple(entry['shape'])}")
        tensors[entry["name"]] = t.to(device)
    for name, file in libraries.items():
        _build.use_library(name, file)
    return _AOTEngine(meta, tensors, device)


def _unflatten(tensors: Dict[str, torch.Tensor], folds: int) -> List[Dict]:
    """`_resolved`'s names back into one tree a fold (a quantised weight a
    {"w8", "scale"} dict)."""
    trees = [{} for _ in range(folds)]
    for name, t in tensors.items():
        k = 0
        if folds > 1 or name.startswith("fold"):
            head, name = name.split("/", 1)
            k = int(head[len("fold"):])
        key, _, part = name.partition("/")
        if part:
            trees[k].setdefault(key, {})[part] = t
        else:
            trees[k][key] = t
    return trees


class _AOTEngine(_SlabEngine):
    """An engine rebuilt from an artifact: the `_SlabEngine` surface of the
    engine that was saved, its module built on the `meta` device with the
    stored tensors assigned, its step that engine's."""

    def __init__(self, meta: dict, tensors: Dict[str, torch.Tensor], device: torch.device):
        cfg = meta["config"]
        self.meta, self.config, self.kind = meta, cfg, meta["kind"]
        self.model_name, self.quantize = cfg["model_name"], meta["quantize"]
        self.batch_size = int(meta["batch_size"])
        self.volume_shape = tuple(meta["volume_shape"])
        self.normalize, self.resize = meta["normalize"], bool(meta["resize"])
        self.device, self.mesh = device, None
        self._lock = threading.Lock()
        mae_cfg = MODEL_ZOO[cfg["model_name"]](volume_size=cfg["volume_size"], in_chans=cfg["in_chans"],
                                               patch_size=cfg["patch_size"], dtype=cfg["compute_dtype"],
                                               attn_impl=cfg["attn_impl"])
        vit_cfg = mae_cfg.encoder_vit_config(num_classes=meta.get("num_classes", 2), global_pool=True)
        int8 = self.quantize == "int8"
        with torch.device("meta"):
            skeleton = build_model(vit_cfg).eval()
        if self.kind == "features":
            (tree,) = _unflatten(tensors, 1)
            if int8:
                self.model = QuantizedViT.from_quantized(tree, vit_cfg)
            else:
                skeleton.load_state_dict(tree, strict=True, assign=True)
                self.model = skeleton
            self.feature_dim = int(meta["feature_dim"])
            self._step = lambda batch: feature_step(self.model, batch)
        elif self.kind == "classify":
            trees = _unflatten(tensors, int(meta["num_folds"]))
            self.folds = [QuantizedViT.from_quantized(t, vit_cfg) if int8 else t for t in trees]
            self.model = skeleton
            self.num_classes, self.num_folds = int(meta["num_classes"]), len(self.folds)
            self._step = ensemble_step(skeleton, self.folds)
        else:
            raise RuntimeError(f"unknown engine kind {self.kind!r}")
