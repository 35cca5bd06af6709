"""`doctor`: environment diagnostics for the port.

The port's counterpart of the JAX package's utils/doctor.py: one place that
answers "why does it not run here". Its checks are the port's own: the CUDA
device and a round trip on it, the toolchain (nvcc for sm_90a, g++), the
CUDA kernel libraries and the host C++ libraries built and loaded, the
build directory (whose digest-keyed entries take the place of JAX's
compilation cache), torch.distributed's backends, library versions, the
optional extras and the engine artifacts under the working directory. Each
check prints ok / warn / FAIL with a one-line detail; a check that crashes
fails; the exit code is 1 when any check fails.
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import subprocess
import time
import zipfile
from typing import Callable, List, Optional, Tuple

_OK, _WARN, _FAIL = "ok", "warn", "FAIL"

Check = Callable[[str], Tuple[str, str]]


def _on_cpu(device: str) -> bool:
    import torch

    return torch.device(device).type == "cpu"


def _check_cuda(device: str) -> Tuple[str, str]:
    import torch

    detail = f"torch {torch.__version__}, CUDA {torch.version.cuda}"
    if not torch.cuda.is_available():
        if _on_cpu(device):
            return _WARN, detail + ": no CUDA device, CPU only (as --device cpu asks)"
        return _FAIL, detail + ": no CUDA device (the port runs on cuda unless --device cpu is given)"
    cards = [f"{torch.cuda.get_device_name(i)} (sm_{''.join(map(str, torch.cuda.get_device_capability(i)))})"
             for i in range(torch.cuda.device_count())]
    return _OK, detail + f", {len(cards)} card(s): " + ", ".join(cards)


def _check_device_compute(device: str) -> Tuple[str, str]:
    import torch

    t0 = time.time()
    x = torch.ones((256, 256), device=device)
    s = float((x @ x).sum())  # the host read waits for the device
    if s != 256.0 ** 3:
        return _FAIL, f"256^2 matmul on {device} gave {s}, expected {256 ** 3}"
    return _OK, f"256^2 matmul round trip on {device} in {time.time() - t0:.2f}s"


def _check_toolchain(device: str) -> Tuple[str, str]:
    from vit_ae_plus_plus_torch.kernels import _build

    gxx = shutil.which("g++")
    gxx_line = (subprocess.run([gxx, "--version"], capture_output=True, text=True).stdout.splitlines() or ["?"])[0] \
        if gxx else None
    try:
        nvcc = _build.nvcc_path()
    except RuntimeError as e:
        status = _WARN if _on_cpu(device) else _FAIL
        return status, f"{e}; g++: {gxx_line or 'not found'}"
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    release = re.search(r"release (\d+)\.(\d+)", version)
    detail = f"nvcc {nvcc} (CUDA {'.'.join(release.groups()) if release else '?'}), g++: {gxx_line or 'not found'}"
    if release is None or int(release.group(1)) < 12:  # sm_90a came with CUDA 12.0
        return _FAIL, detail + ": this nvcc does not build sm_90a (the kernels need CUDA 12 or later)"
    if gxx is None:
        return _FAIL, detail + ": g++ builds the host libraries"
    return _OK, detail + ", builds sm_90a"


def _check_kernel_libraries(device: str) -> Tuple[str, str]:
    from vit_ae_plus_plus_torch.kernels import _build

    if _on_cpu(device):
        return _WARN, "not checked under --device cpu (the CUDA kernels build and load on a machine with a card)"
    t0 = time.time()
    _build.build()
    for name in _build.SOURCES:
        _build.load(name)
    digests = ", ".join(f"{n} {_build.source_digest(n)[:12]}" for n in _build.SOURCES)
    return _OK, f"{len(_build.SOURCES)} built and loaded in {time.time() - t0:.2f}s from {_build.BUILD_DIR}: {digests}"


def _host_libraries():
    """(name, library_path, load) of each host C++ library."""
    from vit_ae_plus_plus_torch.data import native_augment
    from vit_ae_plus_plus_torch.utils import liblinear, libsvm, sag, tree

    return [("augment3d", native_augment.library_path, native_augment.available)] + [
        (m.__name__.rsplit(".", 1)[1], m.library_path, m.load) for m in (libsvm, liblinear, sag, tree)]


def _current_entries() -> set:
    """The build directory's file names that this checkout's sources map to."""
    from vit_ae_plus_plus_torch.kernels import _build

    names = {_build.library_path(n).name for n in _build.SOURCES}
    names |= {_build.library_path(n).with_suffix(".log").name for n in _build.SOURCES}
    return names | {path().name for _, path, _ in _host_libraries()}


def _check_build_dir(device: str) -> Tuple[str, str]:
    from vit_ae_plus_plus_torch.kernels import _build

    path = _build.BUILD_DIR
    path.mkdir(parents=True, exist_ok=True)
    probe = path / f".doctor-probe.{os.getpid()}"
    probe.write_text("x")
    probe.unlink()
    entries = sorted(p.name for p in path.iterdir() if p.is_file() and p.suffix in (".so", ".log"))
    stale = [e for e in entries if e not in _current_entries()]
    detail = f"{path} writable, {len(entries)} entrie(s)"
    if stale:
        shown = ", ".join(stale[:3]) + ("..." if len(stale) > 3 else "")
        return _WARN, detail + f"; {len(stale)} built from sources this checkout no longer has ({shown}): " \
                               "unused, safe to delete"
    return _OK, detail + ", each keyed by a current source digest"


def _check_host_libraries(device: str) -> Tuple[str, str]:
    ok, failed = [], []
    for name, _, load in _host_libraries():
        try:
            if load() is False:  # native_augment.available()
                raise RuntimeError("unavailable (g++ or native/augment3d.cpp)")
            ok.append(name)
        except Exception as e:
            failed.append(f"{name}: {type(e).__name__}: {str(e).splitlines()[0] if str(e) else ''}")
    if failed:
        return _FAIL, "; ".join(failed) + (f" (loaded: {', '.join(ok)})" if ok else "")
    return _OK, "built and loaded: " + ", ".join(ok)


def _check_distributed(device: str) -> Tuple[str, str]:
    import torch
    import torch.distributed as dist

    if not dist.is_available():
        return _FAIL, "torch.distributed is not available in this torch build"
    gloo, nccl = dist.is_gloo_available(), dist.is_nccl_available()
    detail = f"gloo {'yes' if gloo else 'no'}, nccl {'yes' if nccl else 'no'}, {torch.cuda.device_count()} visible card(s)"
    if not gloo:
        return _FAIL, detail + ": --n-devices with --device cpu needs gloo"
    if not _on_cpu(device) and not nccl:
        return _WARN, detail + ": --n-devices on cards needs nccl"
    return _OK, detail + " (NCCL takes one rank per card)"


def _check_versions(device: str) -> Tuple[str, str]:
    import numpy as np
    import scipy
    import torch

    cudnn = torch.backends.cudnn.version() if torch.backends.cudnn.is_available() else None
    return _OK, (f"torch {torch.__version__}, CUDA {torch.version.cuda}, cuDNN {cudnn}, "
                 f"numpy {np.__version__}, scipy {scipy.__version__}")


def _check_optional(device: str) -> Tuple[str, str]:
    have, missing = [], []
    for mod, why in (("pandas", "prepare-data egd's CSV"),
                     ("nibabel", "NIfTI through nibabel; the port's own reader and writer work without it"),
                     ("matplotlib", "sanity-viz's PNGs and explore-data")):
        try:
            __import__(mod)
            have.append(mod)
        except ImportError:
            missing.append(f"{mod} ({why})")
    msg = "present: " + (", ".join(have) or "none")
    if missing:
        return _WARN, msg + "; missing: " + "; ".join(missing)
    return _OK, msg


def _check_engines(device: str) -> Tuple[str, str]:
    """Artifacts that serve --engine would refuse here: another format or
    version, another fingerprint (serving_aot.fingerprint), or kernel
    libraries built from other sources."""
    from vit_ae_plus_plus_torch.kernels import _build
    from vit_ae_plus_plus_torch.serving_aot import FORMAT, FORMAT_VERSION, fingerprint

    paths = sorted(glob.glob("*.vitae") + glob.glob("*/*.vitae"))[:50]
    if not paths:
        return _OK, "no .vitae artifacts under the working directory"
    stale = []
    for p in paths:
        try:
            with zipfile.ZipFile(p) as zf:
                meta = json.loads(zf.read("meta.json"))
        except Exception as e:
            stale.append(f"{p}: unreadable ({type(e).__name__})")
            continue
        if meta.get("format") != FORMAT or meta.get("format_version") != FORMAT_VERSION:
            stale.append(f"{p}: format {meta.get('format')!r} version {meta.get('format_version')} "
                         f"(this build reads version {FORMAT_VERSION})")
            continue
        built, here = meta.get("fingerprint") or {}, fingerprint(device)
        diff = next((k for k in here if built.get(k) != here[k]), None)
        if diff is not None:
            stale.append(f"{p}: {diff} {built.get(diff)!r} != {here[diff]!r}")
            continue
        other = [n for n, lib in (meta.get("kernels") or {}).items() if lib.get("sources") != _build.source_digest(n)]
        if other:
            stale.append(f"{p}: kernel sources of {', '.join(other)} differ from this checkout's")
    if stale:
        return _WARN, "stale engine artifact(s), rebuild with compile-engine: " + "; ".join(stale)
    return _OK, f"{len(paths)} artifact(s) match this machine"


CHECKS: List[Tuple[str, Check]] = [
    ("cuda device", _check_cuda),
    ("device compute", _check_device_compute),
    ("toolchain", _check_toolchain),
    ("kernel libraries", _check_kernel_libraries),
    ("build directory", _check_build_dir),
    ("native host libraries", _check_host_libraries),
    ("distributed", _check_distributed),
    ("library versions", _check_versions),
    ("optional extras", _check_optional),
    ("engine artifacts", _check_engines),
]


def run_doctor(checks: Optional[List[Tuple[str, Check]]] = None, device: Optional[str] = None) -> int:
    """Run every check for `device` (cuda unless 'cpu' is given); -> 0 when
    none fails, else 1."""
    device = device or "cuda"
    failed = 0
    for name, fn in (checks or CHECKS):
        try:
            status, detail = fn(device)
        except Exception as e:  # a crashing check is itself a failure
            status, detail = _FAIL, f"check crashed: {type(e).__name__}: {e}"
        print(f"[{status:>4}] {name}: {detail}")
        failed += status == _FAIL
    print("doctor:", "all checks passed" if not failed else f"{failed} check(s) FAILED")
    return 1 if failed else 0
