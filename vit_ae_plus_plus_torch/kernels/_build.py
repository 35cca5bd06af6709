"""Build the port's CUDA sources with nvcc at first use and load them with ctypes;
build its host C++ libraries with g++ (`build_shared`, `host_library_path`,
and `scipy_blas` for the BLAS functions they call).

Each source under `csrc/` has a plain C interface, so it compiles in
seconds with `nvcc -shared` (no PyTorch headers) into
`vit_ae_plus_plus_torch/build/`. The library's file name carries a hash of
the source, the headers under `csrc/` and the flags: an edited source or
header is rebuilt, never loaded stale.
Nothing is built when a module is imported; `load` builds on first call.
Every source exports its launchers as `int fn(const Params*, int is_bf16,
int device, void* stream)` returning the CUDA error, and
`<source>_error_string`; `launch` calls one.

A precompiled serving engine (serving_aot.py) ships the libraries its step
loaded (`recording`) and, at load, hands them to `use_library`: `load`
then returns them and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import contextlib
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Union

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
_files: Dict[str, Path] = {}  # the file each loaded library came from
_recorders: list = []  # the sets `recording` fills


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


def source_digest(name: str) -> str:
    """The sha256 of csrc/<name>.cu, the headers under csrc/ and the flags:
    what a library built from this checkout is keyed by."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(name)[:16]}.so"


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


def build_shared(src: Union[Path, Sequence[Path]], flags: Iterable[str], so_path: Path) -> None:
    """Compile the host C++ source `src` (or the translation units listed)
    with g++ `flags` into the shared library `so_path`, through a temporary
    file beside it that `os.replace` moves into place, so a process loading
    the library while another builds it never opens half a file. Raises
    `RuntimeError` naming the cause when g++ is missing or fails."""
    srcs = [src] if isinstance(src, Path) else list(src)
    so_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), *map(str, srcs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {srcs[0]}:\n{proc.stderr}")
        os.replace(tmp, so_path)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ is needed to build {srcs[0]} and was not found") from e
    finally:
        tmp.unlink(missing_ok=True)


def host_library_path(stem: str, files: Iterable[Path], flags: Iterable[str], build_dir: Path = BUILD_DIR) -> Path:
    """The path in `build_dir` of the host library `stem` built with g++
    `flags` from `files` (its sources and what they include), keyed by a
    hash of their bytes and the flags: an edited source is rebuilt, never
    loaded stale."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in files:
        h.update(Path(path).read_bytes())
    return build_dir / f"_{stem}_{sys.platform}_{h.hexdigest()[:12]}.so"


def scipy_blas(name: str, signature: str) -> int:
    """The address of scipy's Fortran BLAS function `name` from
    `scipy.linalg.cython_blas`'s capsule, as scikit-learn's Cython calls
    it. Raises `RuntimeError` unless scipy declares it as `signature`
    (scipy's typedef of double read as double; an ILP64 BLAS has other
    integer types)."""
    from scipy.linalg import cython_blas

    capsule = cython_blas.__pyx_capi__[name]
    get_name = ctypes.pythonapi.PyCapsule_GetName
    get_name.restype, get_name.argtypes = ctypes.c_char_p, [ctypes.py_object]
    get_pointer = ctypes.pythonapi.PyCapsule_GetPointer
    get_pointer.restype, get_pointer.argtypes = ctypes.c_void_p, [ctypes.py_object, ctypes.c_char_p]
    declared = get_name(capsule)
    if re.sub(r"\S*cython_blas_d\b", "double", declared.decode()) != signature:
        raise RuntimeError(f"scipy's {name} has the signature {declared.decode()!r}, not {signature!r}")
    return get_pointer(capsule, declared)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed (or
    the one `use_library` gave)."""
    with _lock:
        for names in _recorders:
            names.add(name)
        lib = _loaded.get(name)
        if lib is None:
            _files[name] = build((name,))[name]
            lib = _loaded[name] = ctypes.CDLL(str(_files[name]))
        return lib


def loaded_file(name: str) -> Path:
    """The file of the library `load` returns for csrc/<name>.cu."""
    with _lock:
        return _files[name]


def use_library(name: str, path: Path) -> None:
    """Load the library at `path` as csrc/<name>.cu's: `load` returns it
    from now on in this process."""
    with _lock:
        _loaded[name] = ctypes.CDLL(str(path))
        _files[name] = Path(path)


@contextlib.contextmanager
def recording():
    """A set that collects the name of every library `load` is asked for
    inside the block."""
    names: set = set()
    with _lock:
        _recorders.append(names)
    try:
        yield names
    finally:
        with _lock:
            _recorders.remove(names)


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
