"""ctypes bindings for the native host-augmentation library
(native/augment3d.cpp, a copy of the JAX package's source).

Why native: the host stage of the input pipeline runs the torchio-default
policy per sample (reference k_fold_cross_valid_combined_brats.py:93-97).
scipy's generic spline resampler costs ~60-240 ms per 96^3 volume per core;
the C++ trilinear kernel runs the same math in a few ms, so a small host can
keep the card fed. Compiled on demand with g++ (rebuilt when the source is
newer than the library); everything falls back to the scipy path when no
compiler is available.

The library is built into a temporary file in `build/` beside the package
(gitignored) and moved into place with `os.replace`, so a process that
loads it while another builds it never opens half a file. Its name carries
the host CPU's `-march=native` target flags: a build directory shared
between unlike hosts never hands one a binary with instructions it lacks.

Distribution parity: the POLICY parameters (scales, angles, noise std, gamma)
are drawn from the same numpy Generator stream as the scipy implementations
in data/transforms.py, so the two paths sample identical augmentation
distributions; the affine output matches scipy.ndimage.affine_transform
(order=1, mode='constant') to float tolerance. Only the per-voxel noise FIELD
comes from a native RNG (xoshiro256++ Box-Muller) seeded from the same stream
— equal in distribution, not bitwise.

ctypes releases the GIL for the length of each native call, so the
Loader's threads augment volumes in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import platform
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from vit_ae_plus_plus_torch.data.transforms import Transform
from vit_ae_plus_plus_torch.kernels._build import BUILD_DIR, build_shared

# the C++ source ships inside the package (native/) so installs carry it
SRC = Path(__file__).resolve().parents[1] / "native" / "augment3d.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    """The library's path in BUILD_DIR, keyed by the host's target flags."""
    try:
        target = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            check=True, capture_output=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        target = platform.processor().encode()
    host_key = hashlib.sha256(platform.machine().encode() + target).hexdigest()[:12]
    return BUILD_DIR / f"_augment3d_{sys.platform}_{host_key}.so"


def _build_and_load() -> Optional[ctypes.CDLL]:
    """Compile (if stale) and dlopen the library; None when unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not SRC.exists():
            return None
        so_path = library_path()
        try:
            if not so_path.exists() or so_path.stat().st_mtime < SRC.stat().st_mtime:
                build_shared(SRC, GXX_FLAGS, so_path)
            lib = ctypes.CDLL(str(so_path))
        except (OSError, RuntimeError):
            return None
        lib.affine3d_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
        lib.add_gaussian_noise_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
            ctypes.c_uint64,
        ]
        lib.gamma_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ]
        for name in ("zscore_f32", "minmax_f32"):
            getattr(lib, name).argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ]
        for name in ("affine3d_f32", "add_gaussian_noise_f32", "gamma_f32",
                     "zscore_f32", "minmax_f32"):
            getattr(lib, name).restype = None
        _LIB = lib
        return _LIB


def available() -> bool:
    return _build_and_load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def affine3d(volume: np.ndarray, mat: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """scipy.ndimage.affine_transform(order=1, mode='constant', cval=0)
    equivalent for one (Z, Y, X) f32 volume."""
    lib = _build_and_load()
    vol = np.ascontiguousarray(volume, np.float32)
    out = np.empty_like(vol)
    m = np.ascontiguousarray(mat, np.float64)
    off = np.ascontiguousarray(offset, np.float64)
    lib.affine3d_f32(
        _fptr(vol), _fptr(out), *vol.shape,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


class NativeRandomAffine3D(Transform):
    """Drop-in RandomAffine3D (same parameter stream, native resampler)."""

    def __init__(self, scales: float = 0.1, degrees: float = 10.0):
        self.scales = scales
        self.degrees = degrees

    def __call__(self, volume, rng):
        # identical parameter draws to transforms.RandomAffine3D (order matters)
        scale = rng.uniform(1 - self.scales, 1 + self.scales, size=3)
        angles = rng.uniform(-self.degrees, self.degrees, size=3) * math.pi / 180.0

        def rot(axis, a):
            c_, s_ = math.cos(a), math.sin(a)
            m = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            m[i, i] = c_
            m[i, j] = -s_ if axis != 1 else s_
            m[j, i] = s_ if axis != 1 else -s_
            m[j, j] = c_
            return m

        mat = rot(0, angles[0]) @ rot(1, angles[1]) @ rot(2, angles[2]) @ np.diag(1.0 / scale)
        center = (np.asarray(volume.shape[1:]) - 1) / 2.0
        offset = center - mat @ center
        out = np.empty_like(volume)
        for i in range(volume.shape[0]):
            out[i] = affine3d(volume[i], mat, offset)
        return out


class NativeRandomNoise(Transform):
    """Gaussian noise, std ~ U(0, std); the noise field is generated natively
    (xoshiro256++ Box-Muller), seeded from the same numpy stream."""

    def __init__(self, std: float = 0.1):
        self.std = std

    def __call__(self, volume, rng):
        std = rng.uniform(0, self.std)
        seed = int(rng.integers(0, 2**63 - 1))
        out = np.ascontiguousarray(volume, np.float32)
        if out is volume:
            out = volume.copy()
        _build_and_load().add_gaussian_noise_f32(_fptr(out), out.size, std, seed)
        return out


class NativeRandomGamma(Transform):
    """Intensity power transform, gamma = exp(U(log_gamma))."""

    def __init__(self, log_gamma=(-0.3, 0.3)):
        self.log_gamma = log_gamma

    def __call__(self, volume, rng):
        gamma = math.exp(rng.uniform(*self.log_gamma))
        out = np.ascontiguousarray(volume, np.float32)
        if out is volume:
            out = volume.copy()
        _build_and_load().gamma_f32(_fptr(out), out.size, gamma)
        return out


def znorm(volume: np.ndarray) -> np.ndarray:
    """In-place-free per-volume z-score (brats.py:26-29 semantics)."""
    out = np.ascontiguousarray(volume, np.float32).copy()
    _build_and_load().zscore_f32(_fptr(out), out.size)
    return out


def minmax(volume: np.ndarray) -> np.ndarray:
    """Min-max to [-1, 1] (brats.py:30-32 semantics)."""
    out = np.ascontiguousarray(volume, np.float32).copy()
    _build_and_load().minmax_f32(_fptr(out), out.size)
    return out
