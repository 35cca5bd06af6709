"""Build the port's CUDA sources with nvcc at first use and load them with ctypes.

Each source under `csrc/` has a plain C interface, so it compiles in
seconds with `nvcc -shared` (no PyTorch headers) into
`vit_ae_plus_plus_torch/build/`. The library's file name carries a hash of
the source, the headers under `csrc/` and the flags: an edited source or
header is rebuilt, never loaded stale.
Nothing is built when a module is imported; `load` builds on first call.
Every source exports its launchers as `int fn(const Params*, int is_bf16,
int device, void* stream)` returning the CUDA error, and
`<source>_error_string`; `launch` calls one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
SOURCES = ("flash_fwd", "flash_bwd", "layernorm", "ln_dense")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # one dlopen per library and process


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from source on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, all nvcc processes
    at once; returns the library paths. The compiler's report (registers,
    shared memory, spills) is kept beside each library as `.log`."""
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _loaded[name] = lib
        return lib


def launch(source: str, fn_name: str, params: ctypes.Structure, t: torch.Tensor) -> None:
    """Call `fn_name(&params, is_bf16, device, stream)` of csrc/<source>.cu
    on t's device and current stream (the kernel does not synchronise);
    raise on the CUDA error it returns, a refused launch included."""
    lib = load(source)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.POINTER(type(params)), ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(t.device).cuda_stream
    err = fn(ctypes.byref(params), int(t.dtype == torch.bfloat16), t.device.index or 0, stream)
    if err != 0:
        msg = getattr(lib, f"{source}_error_string")
        msg.argtypes = [ctypes.c_int]
        msg.restype = ctypes.c_char_p
        raise RuntimeError(f"{fn_name} launch failed: {msg(err).decode()}")
