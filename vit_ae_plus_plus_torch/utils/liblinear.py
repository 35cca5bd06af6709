"""ctypes bindings for the port's copy of scikit-learn's liblinear.

The GPU machine has no scikit-learn, and the classical evaluation fits
`sklearn.linear_model.LogisticRegression`, whose "liblinear" solver is
scikit-learn's modified liblinear: the primal trust-region Newton method
(TRON) on the L2-regularised logistic loss, with the intercept as a bias
column that is regularised like the weights, through scipy's BLAS. So the
port carries that library (native/liblinear/, scikit-learn 1.9.0, see
COPYING there) and calls it as sklearn/svm/_liblinear.pyx `train_wrap` and
sklearn/svm/_base.py `_fit_liblinear` do, for dense input.

The library is built at first use with g++ into `build/` beside the
package (gitignored) from its three translation units, named by a hash of
its sources and flags, through a temporary file that `os.replace` moves
into place. The flags keep the wheel's rounding: no `-ffast-math`, no
`-march=native`, and `-ffp-contract=off`. The BLAS functions are scipy's
`ddot`, `daxpy`, `dscal` and `dnrm2`, the ones sklearn passes
(sklearn/utils/_cython_blas.pyx), taken from `scipy.linalg.cython_blas`'s
capsules. There is no fallback: with no g++, a failed build or a BLAS
function of another signature, `load` raises and names the cause.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vit_ae_plus_plus_torch.kernels._build import BUILD_DIR, build_shared, host_library_path, scipy_blas
from vit_ae_plus_plus_torch.utils.optimize import ConvergenceWarning

NATIVE = Path(__file__).resolve().parents[1] / "native"
SRC_DIR = NATIVE / "liblinear"
# the translation units first, then what they include (libsvm's copy of
# scikit-learn's newrand.h seeds the solvers that draw random numbers)
UNITS = ("vitae_liblinear.cpp", "linear.cpp", "tron.cpp")
SOURCES = UNITS + ("linear.h", "tron.h", "liblinear_helper.c", "_cython_blas_helpers.h")
INCLUDED = (NATIVE / "libsvm" / "newrand.h",)
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
# the Fortran signatures sklearn calls (kernels/_build.py scipy_blas)
BLAS_SIGNATURES = {
    "ddot": "double (int *, double *, int *, double *, int *)",
    "daxpy": "void (int *, double *, double *, int *, double *, int *)",
    "dscal": "void (int *, double *, double *, int *)",
    "dnrm2": "double (int *, double *, int *)",
}
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path in BUILD_DIR, keyed by its sources and flags."""
    return host_library_path("liblinear", [SRC_DIR / name for name in SOURCES] + list(INCLUDED), GXX_FLAGS,
                             BUILD_DIR)


def build() -> Path:
    """Compile the library unless it is built; -> its path. Raises
    `RuntimeError` naming the cause when g++ is missing or fails."""
    so_path = library_path()
    if not so_path.exists():
        build_shared([SRC_DIR / name for name in UNITS], GXX_FLAGS, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """Build (once) and open the library, with scipy's BLAS functions set."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        blas = [scipy_blas(name, signature) for name, signature in BLAS_SIGNATURES.items()]
        lib = ctypes.CDLL(str(build()))
        lib.vitae_liblinear_set_blas.argtypes = [ctypes.c_void_p] * 4
        lib.vitae_liblinear_set_blas.restype = None
        lib.vitae_liblinear_train.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
            ctypes.c_double, ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.vitae_liblinear_train.restype = ctypes.c_void_p
        for name in ("get_nr_class", "get_nr_feature"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [ctypes.c_void_p], ctypes.c_int
        lib.get_n_iter.argtypes, lib.get_n_iter.restype = [ctypes.c_void_p, ctypes.c_void_p], None
        lib.copy_w.argtypes, lib.copy_w.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], None
        lib.free_and_destroy_model.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
        lib.free_and_destroy_model.restype = None
        lib.vitae_liblinear_set_blas(*blas)
        _LIB = lib
        return lib


def train_wrap(X, Y, solver_type: int, eps: float, bias: float, C: float, class_weight, max_iter: int,
               random_seed: int, epsilon: float, sample_weight) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn/svm/_liblinear.pyx `train_wrap` for dense float32 or float64
    rows X, float64 labels Y (class indices 0 and 1) and sample weights ->
    (w of shape (1, n_features + (bias > 0)), float64; n_iter of shape (1,),
    int32). Raises `ValueError` with liblinear's message when it refuses the
    parameters, and when Y holds other than two classes."""
    lib = load()
    X = np.ascontiguousarray(X)
    if X.dtype not in (np.float32, np.float64) or X.ndim != 2:
        raise ValueError(f"liblinear: expected 2-d float32 or float64 rows, got {X.dtype} of shape {X.shape}")
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    sample_weight = np.ascontiguousarray(sample_weight, dtype=np.float64)
    class_weight = np.ascontiguousarray(class_weight, dtype=np.float64)
    if not (Y.shape == sample_weight.shape == (X.shape[0],)):
        raise ValueError(f"liblinear: {X.shape[0]} rows, {Y.shape} labels, {sample_weight.shape} weights")
    class_weight_label = np.arange(class_weight.shape[0], dtype=np.intc)
    error = ctypes.c_char_p()
    model = lib.vitae_liblinear_train(
        X.ctypes.data, int(X.dtype == np.float64), X.shape[0], X.shape[1], int(np.count_nonzero(X)),
        bias, sample_weight.ctypes.data, Y.ctypes.data, solver_type, eps, C,
        class_weight.shape[0], class_weight_label.ctypes.data if class_weight_label.size else None,
        class_weight.ctypes.data if class_weight.size else None, max_iter, random_seed, epsilon,
        ctypes.byref(error))
    if not model:
        raise ValueError((error.value or b"liblinear: train failed").decode())
    try:
        nr_class = lib.get_nr_class(model)
        if nr_class != 2:
            raise ValueError(f"liblinear: {nr_class} classes; only two are ported")
        n_iter = np.zeros(1, dtype=np.intc)
        lib.get_n_iter(model, n_iter.ctypes.data)
        nr_feature = lib.get_nr_feature(model) + (1 if bias > 0 else 0)
        w = np.empty((1, nr_feature), order="F")
        lib.copy_w(w.ctypes.data, model, nr_feature)
    finally:
        handle = ctypes.c_void_p(model)
        lib.free_and_destroy_model(ctypes.byref(handle))
    return w, n_iter


# liblinear's solver number for the L2-regularised logistic loss in the
# primal, sklearn's `_get_liblinear_solver_type("ovr", "l2",
# "logistic_regression", False)`
L2R_LR = 0


def fit_liblinear(X, y, C: float, intercept_scaling: float, max_iter: int, tol: float, random_state=None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """sklearn/svm/_base.py `_fit_liblinear` for the l2 logistic loss in
    the primal with an intercept, `class_weight="balanced"` and no sample
    weights -> (coef_, intercept_, n_iter_). Classes are encoded by
    `np.unique`; the balanced weights are n / (k * bincount) in float64;
    liblinear's seed is `RandomState(random_state).randint(iinfo("i").max)`;
    X gets a bias column of `intercept_scaling`, and the intercept is that
    column's weight times it. Warns `ConvergenceWarning` when liblinear
    stopped at `max_iter`."""
    classes, y_ind = np.unique(y, return_inverse=True)
    if len(classes) < 2:
        raise ValueError("This solver needs samples of at least 2 classes in the data, but the data contains "
                         f"only one class: {classes[0]!r}")
    # sklearn/utils/class_weight.py compute_class_weight("balanced")
    counts = np.bincount(y_ind, weights=np.ones(y_ind.shape[0]))
    class_weight_ = np.sum(counts) / (classes.shape[0] * counts)
    if intercept_scaling <= 0:
        raise ValueError(f"Intercept scaling is {intercept_scaling!r} but needs to be greater than 0.")
    rnd = np.random.RandomState(random_state)
    y_ind = np.asarray(y_ind, dtype=np.float64).ravel()
    sample_weight = np.ones(X.shape[0], dtype=np.float64)
    raw_coef_, n_iter_ = train_wrap(X, y_ind, L2R_LR, tol, intercept_scaling, C, class_weight_, max_iter,
                                    rnd.randint(np.iinfo("i").max), 0.1, sample_weight)
    if max(n_iter_) >= max_iter:
        warnings.warn("Liblinear failed to converge, increase the number of iterations.", ConvergenceWarning)
    return raw_coef_[:, :-1], intercept_scaling * raw_coef_[:, -1], n_iter_
