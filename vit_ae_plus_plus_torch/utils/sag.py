"""scikit-learn's SAG solver for the binary logistic loss, on the port's
native library (native/sag/).

`sag_solver` and `get_auto_step_size` are sklearn/linear_model/_sag.py's
for loss "log", one class and no SAGA, as `LogisticRegression(solver="sag")`
calls them: the step 1 / (0.25 * (max row norm^2 + 1) + alpha / n)
computed in the data's dtype as numpy computes it, the seed
`RandomState.randint(1, iinfo(int32).max)` of sklearn's `make_dataset`,
then `sag32` or `sag64` (native/sag/sag_fast.cpp) on the float32 or
float64 rows as they are. The same library carries the half binomial
loss's per-sample loops that utils/linear_loss.py calls, so one build
serves both.

The library is built at first use with g++ into `build/` beside the
package (gitignored), named by a hash of its sources and flags, with the
flags that keep the wheel's rounding (no `-ffast-math`, no `-march`,
`-ffp-contract=off`). There is no fallback: with no g++ or a failed build,
`load` raises and names the cause.
"""

from __future__ import annotations

import ctypes
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from vit_ae_plus_plus_torch.kernels._build import BUILD_DIR, build_shared, host_library_path
from vit_ae_plus_plus_torch.utils.optimize import ConvergenceWarning

SRC_DIR = Path(__file__).resolve().parents[1] / "native" / "sag"
SOURCES = ("sag_fast.cpp", "loss.h")
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
_SUFFIX = {np.dtype(np.float32): "32", np.dtype(np.float64): "64"}
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path in BUILD_DIR, keyed by its sources and flags."""
    return host_library_path("sag", [SRC_DIR / name for name in SOURCES], GXX_FLAGS, BUILD_DIR)


def build() -> Path:
    """Compile the library unless it is built; -> its path. Raises
    `RuntimeError` naming the cause when g++ is missing or fails."""
    so_path = library_path()
    if not so_path.exists():
        build_shared(SRC_DIR / SOURCES[0], GXX_FLAGS, so_path)
    return so_path


def load() -> ctypes.CDLL:
    """Build (once) and open the library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"vitae_sag{suffix}")
            fn.argtypes = [p, p, p, i, i, ctypes.c_uint32, p, p, d, i, d, d, p, p, p, p, i, p, d, p]
            fn.restype = i
            for name, n_out in (("loss", 1), ("loss_gradient", 2), ("gradient", 1), ("gradient_hessian", 2)):
                fn = getattr(lib, f"vitae_half_binomial_{name}{suffix}")
                fn.argtypes, fn.restype = [i, p, p, p] + [p] * n_out, None
        _LIB = lib
        return lib


def native(name: str, dtype) -> ctypes._CFuncPtr:
    """The library's function `name` for float32 or float64 arrays."""
    return getattr(load(), f"{name}{_SUFFIX[np.dtype(dtype)]}")


def get_auto_step_size(max_squared_sum, alpha_scaled: float):
    """sklearn's SAG step for the log loss with an intercept, 1 / L with
    L = 0.25 * (max_squared_sum + 1) + alpha_scaled (in max_squared_sum's
    dtype, as numpy computes it there)."""
    L = 0.25 * (max_squared_sum + 1) + alpha_scaled
    return 1.0 / L


def sag_solver(X, y, sample_weight, alpha: float, max_iter: int, tol: float, random_state,
               max_squared_sum) -> Tuple[np.ndarray, int]:
    """sklearn's `sag_solver(X, y, sample_weight, "log", alpha, 0, max_iter,
    tol, 0, random_state, False, max_squared_sum, {"coef": zeros})` with an
    intercept, for C-ordered float32 or float64 rows X, labels y in {0, 1}
    and sample weights (both taken in X's dtype) -> (coef with the
    intercept last, in X's dtype; epochs run). Warns `ConvergenceWarning`
    when it stopped at `max_iter`."""
    X = np.ascontiguousarray(X)
    n_samples, n_features = X.shape
    dtype = X.dtype
    y = np.ascontiguousarray(y, dtype=dtype)
    sample_weight = np.ascontiguousarray(sample_weight, dtype=dtype)
    if not (y.shape == sample_weight.shape == (n_samples,)):
        raise ValueError(f"sag: {n_samples} rows, {y.shape} labels, {sample_weight.shape} weights")
    alpha_scaled = float(alpha) / n_samples
    coef = np.zeros((n_features, 1), dtype=dtype)
    intercept = np.zeros(1, dtype=dtype)
    intercept_sum_gradient = np.zeros(1, dtype=dtype)
    gradient_memory = np.zeros((n_samples, 1), dtype=dtype)
    sum_gradient = np.zeros((n_features, 1), dtype=dtype)
    seen = np.zeros(n_samples, dtype=np.int32)
    num_seen = ctypes.c_int(0)
    # sklearn/linear_model/_base.py make_dataset; the seed is never 0
    seed = random_state.randint(1, np.iinfo(np.int32).max)
    step_size = get_auto_step_size(max_squared_sum, alpha_scaled)
    if step_size * alpha_scaled == 1:
        raise ZeroDivisionError("Current sag implementation does not handle the case step_size * alpha_scaled == 1")
    n_iter = ctypes.c_int(0)
    status = native("vitae_sag", dtype)(
        X.ctypes.data, y.ctypes.data, sample_weight.ctypes.data, n_samples, n_features, seed,
        coef.ctypes.data, intercept.ctypes.data, tol, max_iter, step_size, alpha_scaled,
        sum_gradient.ctypes.data, gradient_memory.ctypes.data, seen.ctypes.data, ctypes.byref(num_seen),
        1, intercept_sum_gradient.ctypes.data, 1.0, ctypes.byref(n_iter))
    if status == -2:
        raise MemoryError("sag: out of memory")
    if status == -1:
        raise ValueError(f"Floating-point under-/overflow occurred at epoch #{n_iter.value}. Scaling input data "
                         "with StandardScaler or MinMaxScaler might help.")
    if n_iter.value == max_iter:
        warnings.warn("The max_iter was reached which means the coef_ did not converge", ConvergenceWarning)
    return np.vstack((coef, intercept))[:, 0], n_iter.value
