"""ctypes bindings for the port's copy of scikit-learn's libsvm.

The GPU machine has no scikit-learn, and the classical evaluation fits
`sklearn.svm.SVC` (pipelines/classical_models.py). Its numbers come from
scikit-learn's modified libsvm: the SMO solver, Platt scaling over an
internal 5-fold split shuffled by its own mt19937, the kernel's dot
products through scipy's BLAS. So the port carries that library
(native/libsvm/, scikit-learn 1.9.0, see COPYING there) and calls it as
sklearn/svm/_libsvm.pyx does: `fit`, `predict`, `predict_proba` and
`decision_function` here take and return the same arrays as that module's
functions, for the dense C-SVC.

The library is built at first use with g++ into `build/` beside the package
(gitignored), named by a hash of its sources and flags, through a temporary
file that `os.replace` moves into place. The flags keep the wheel's
rounding: no `-ffast-math`, no `-march=native`, and `-ffp-contract=off`
(GCC would otherwise fuse multiply-adds where the wheel's baseline x86-64
build has none to fuse). The kernel's dot product is scipy's `ddot`, the
function sklearn passes (sklearn/utils/_cython_blas.pyx), taken from
`scipy.linalg.cython_blas`'s capsule: with the same BLAS, every decision
value and probability is sklearn's bit for bit. There is no fallback: with
no g++, a failed build or an unexpected `ddot` signature, `load` raises and
names the cause.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vit_ae_plus_plus_torch.kernels._build import BUILD_DIR, build_shared, host_library_path, scipy_blas

SRC_DIR = Path(__file__).resolve().parents[1] / "native" / "libsvm"
SOURCES = ("vitae_libsvm.cpp", "svm.cpp", "svm.h", "libsvm_helper.c", "_svm_cython_blas_helpers.h",
           "newrand.h")
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
# libsvm's kernel numbers (sklearn/svm/_libsvm.pyx LIBSVM_KERNEL_TYPES) of
# the kernels the search's grid names
KERNELS = {"linear": 0, "rbf": 2}
C_SVC = 0
# sklearn SVC's defaults for what the reference leaves unset: tol, the
# kernel cache in MB, the shrinking heuristic, no iteration limit; degree,
# coef0, nu and epsilon, which a C-SVC with these kernels does not read
TOL, CACHE_SIZE, SHRINKING, MAX_ITER = 1e-3, 200.0, 1, -1
DEGREE, COEF0, NU, EPSILON = 3, 0.0, 0.5, 0.1
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_dbl = ctypes.POINTER(ctypes.c_double)
_int = ctypes.POINTER(ctypes.c_int)
_ssize = ctypes.POINTER(ctypes.c_ssize_t)


def library_path() -> Path:
    """The library's path in BUILD_DIR, keyed by its sources and flags."""
    return host_library_path("libsvm", [SRC_DIR / name for name in SOURCES], GXX_FLAGS, BUILD_DIR)


def build() -> Path:
    """Compile the library unless it is built; -> its path. Raises
    `RuntimeError` naming the cause when g++ is missing or fails."""
    so_path = library_path()
    if not so_path.exists():
        build_shared(SRC_DIR / SOURCES[0], GXX_FLAGS, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """Build (once) and open the library, with scipy's `ddot` set."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.vitae_set_ddot.argtypes, lib.vitae_set_ddot.restype = [ctypes.c_void_p], None
        lib.vitae_svm_fit.argtypes = [
            _dbl, _dbl, _dbl, _ssize,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _int,
            _dbl, ctypes.c_int, ctypes.c_int,
            _int, ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.vitae_svm_fit.restype = ctypes.c_void_p
        lib.vitae_svm_predict.argtypes = [
            ctypes.c_int, _dbl, _ssize, ctypes.c_int,
            _dbl, _ssize, _int, _ssize,
            _ssize, _dbl, _dbl, _int,
            _dbl, _dbl, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, _dbl,
        ]
        lib.vitae_svm_predict.restype = ctypes.c_int
        for name in ("get_l", "get_nr"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [ctypes.c_void_p], ctypes.c_ssize_t
        for name in ("copy_sv_coef", "copy_support", "copy_nSV"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            getattr(lib, name).restype = None
        for name in ("copy_intercept", "copy_SV", "copy_probA", "copy_probB"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, _ssize]
            getattr(lib, name).restype = None
        lib.svm_free_and_destroy_model.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.svm_free_and_destroy_model.restype = None
        lib.vitae_set_ddot(scipy_blas("ddot", "double (int *, double *, int *, double *, int *)"))
        _LIB = lib
        return lib


def _p(a: np.ndarray, kind=_dbl):
    """A pointer to the first element, or NULL for an empty array."""
    return a.ctypes.data_as(kind) if a.size else None


def _dims(a: np.ndarray) -> np.ndarray:
    return np.array(a.shape, dtype=np.intp)


def _checked(a, dtype, ndim: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.ndim != ndim:
        raise ValueError(f"libsvm: expected a {ndim}-d array, got shape {a.shape}")
    return a


def fit(X, Y, kernel: str = "rbf", gamma: float = 0.1, C: float = 1.0, class_weight=None,
        probability: bool = False, random_seed: int = 0) -> Tuple[np.ndarray, ...]:
    """Train a C-SVC on float64 rows X with labels Y encoded 0..k-1 (as
    float64), every sample of weight 1; sklearn/svm/_libsvm.pyx `fit` with
    svm_type 0 at the module's constants -> (support, support_vectors,
    n_class_SV, sv_coef, intercept, probA, probB)."""
    lib = load()
    X = _checked(X, np.float64, 2)
    Y = _checked(Y, np.float64, 1)
    if Y.shape[0] != X.shape[0]:
        raise ValueError(f"libsvm: {X.shape[0]} rows but {Y.shape[0]} labels")
    sw = np.ones(X.shape[0])
    cw = np.empty(0) if class_weight is None else _checked(class_weight, np.float64, 1)
    cw_label = np.arange(cw.shape[0], dtype=np.int32)
    status = ctypes.c_int(0)
    error = ctypes.c_char_p()
    model = lib.vitae_svm_fit(
        _p(X), _p(Y), _p(sw), _dims(X).ctypes.data_as(_ssize),
        C_SVC, KERNELS[kernel], DEGREE, gamma, COEF0, NU, CACHE_SIZE, C, TOL, EPSILON,
        SHRINKING, int(probability), cw.shape[0], _p(cw_label, _int), _p(cw), MAX_ITER, random_seed,
        ctypes.byref(status), ctypes.byref(error))
    if not model:
        raise ValueError(f"libsvm: {(error.value or b'svm_train failed').decode()}")
    try:
        sv_len, n_class = lib.get_l(model), lib.get_nr(model)
        m = n_class * (n_class - 1) // 2
        sv_coef = np.empty((n_class - 1, sv_len))
        if sv_coef.size:
            lib.copy_sv_coef(sv_coef.ctypes.data, model)
        intercept = np.empty(m)
        lib.copy_intercept(intercept.ctypes.data, model, _dims(intercept).ctypes.data_as(_ssize))
        support = np.empty(sv_len, dtype=np.int32)
        if support.size:
            lib.copy_support(support.ctypes.data, model)
        support_vectors = np.empty((sv_len, X.shape[1]))
        if support_vectors.size:
            lib.copy_SV(support_vectors.ctypes.data, model, _dims(support_vectors).ctypes.data_as(_ssize))
        n_class_sv = np.empty(n_class, dtype=np.int32)
        lib.copy_nSV(n_class_sv.ctypes.data, model)
        if probability:
            prob_a, prob_b = np.empty(m), np.empty(m)
            lib.copy_probB(prob_b.ctypes.data, model, _dims(prob_b).ctypes.data_as(_ssize))
            lib.copy_probA(prob_a.ctypes.data, model, _dims(prob_a).ctypes.data_as(_ssize))
        else:
            prob_a, prob_b = np.empty(0), np.empty(0)
    finally:
        handle = ctypes.c_void_p(model)
        lib.svm_free_and_destroy_model(ctypes.byref(handle))
    return support, support_vectors, n_class_sv, sv_coef, intercept, prob_a, prob_b


def _predict(what: int, width: int, X, support, SV, nSV, sv_coef, intercept, probA, probB,
             kernel: str, gamma: float) -> np.ndarray:
    lib = load()
    X = _checked(X, np.float64, 2)
    SV = _checked(SV, np.float64, 2)
    if SV.shape[1] != X.shape[1]:
        raise ValueError(f"libsvm: X has {X.shape[1]} features, the support vectors {SV.shape[1]}")
    support = _checked(support, np.int32, 1)
    nSV = _checked(nSV, np.int32, 1)
    sv_coef = _checked(sv_coef, np.float64, 2)
    intercept = _checked(intercept, np.float64, 1)
    probA, probB = _checked(probA, np.float64, 1), _checked(probB, np.float64, 1)
    out = np.empty((X.shape[0], width)) if width else np.empty(X.shape[0])
    rv = lib.vitae_svm_predict(
        what, _p(X), _dims(X).ctypes.data_as(_ssize), nSV.shape[0],
        _p(SV), _dims(SV).ctypes.data_as(_ssize), _p(support, _int), _dims(support).ctypes.data_as(_ssize),
        np.array(sv_coef.strides, dtype=np.intp).ctypes.data_as(_ssize), _p(sv_coef), _p(intercept),
        _p(nSV, _int), _p(probA), _p(probB), C_SVC, KERNELS[kernel], DEGREE, gamma, COEF0,
        CACHE_SIZE, _p(out))
    if rv < 0:
        raise MemoryError("libsvm: out of memory")
    return out


def predict(X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel="rbf", gamma=0.1) -> np.ndarray:
    """The predicted class index of each row (float64), as `_libsvm.predict`."""
    return _predict(0, 0, X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel, gamma)


def predict_proba(X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel="rbf",
                  gamma=0.1) -> np.ndarray:
    """(n, n_class) Platt probabilities, as `_libsvm.predict_proba`."""
    if not (np.size(probA) and np.size(probB)):
        raise ValueError("libsvm: predict_proba needs a model fitted with probability=1")
    return _predict(1, len(nSV), X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel, gamma)


def decision_function(X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel="rbf",
                      gamma=0.1) -> np.ndarray:
    """(n, k(k-1)/2) one-against-one decision values, as
    `_libsvm.decision_function` (libsvm's sign: sklearn flips it for two
    classes)."""
    k = len(nSV)
    return _predict(2, k * (k - 1) // 2, X, support, SV, nSV, sv_coef, intercept, probA, probB, kernel, gamma)
