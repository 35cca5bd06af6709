"""scikit-learn's decision tree builder on the port's native library
(native/tree/).

`build_tree` grows one classification tree as
`DepthFirstTreeBuilder(BestSplitter(...)).build` does in scikit-learn
1.9.0, for one output on dense float32 rows without missing values, and
returns a `Tree` with the arrays of sklearn's `tree_` (`children_left`,
`children_right`, `feature`, `threshold`, `impurity`, `n_node_samples`,
`weighted_n_node_samples`, `missing_go_to_left`, `value`) in the same
dtypes; `Tree.apply` and `Tree.predict` walk it for float32 rows.

The library is built at first use with g++ into `build/` beside the
package (gitignored), named by a hash of its sources and flags, with the
flags that keep the wheel's rounding (no `-ffast-math`, no `-march`,
`-ffp-contract=off`). There is no fallback: with no g++ or a failed build,
`load` raises and names the cause.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from vit_ae_plus_plus_torch.kernels._build import BUILD_DIR, build_shared, host_library_path

SRC_DIR = Path(__file__).resolve().parents[1] / "native" / "tree"
SOURCES = ("tree.cpp", "splitter.h", "criterion.h", "utils.h")
GXX_FLAGS = ("-O2", "-ffp-contract=off", "-fPIC", "-shared")
CRITERIA = {"gini": 0, "entropy": 1}
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """The library's path in BUILD_DIR, keyed by its sources and flags."""
    return host_library_path("tree", [SRC_DIR / name for name in SOURCES], GXX_FLAGS, BUILD_DIR)


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
        p, i64, d = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        lib.vitae_tree_build.argtypes = [p, i64, i64, p, p, i64, ctypes.c_int, i64, i64, i64, i64, d, d,
                                         ctypes.c_uint32, p, p]
        lib.vitae_tree_build.restype = p
        lib.vitae_tree_copy.argtypes = [p] * 10
        lib.vitae_tree_copy.restype = None
        lib.vitae_tree_free.argtypes = [p]
        lib.vitae_tree_free.restype = None
        lib.vitae_tree_apply.argtypes = [p, p, p, p, p, p, i64, i64, p]
        lib.vitae_tree_apply.restype = None
        lib.vitae_simultaneous_sort_f32.argtypes = [p, p, i64, ctypes.c_int]
        lib.vitae_simultaneous_sort_f32.restype = None
        _LIB = lib
        return lib


class Tree:
    """A grown tree: sklearn's `Tree` arrays for its `node_count` nodes,
    `value` of shape (node_count, 1, n_classes), and `max_depth`."""

    def __init__(self, node_count: int, n_classes: int, max_depth: int):
        self.node_count, self.n_classes, self.max_depth = node_count, n_classes, max_depth
        self.children_left = np.empty(node_count, dtype=np.intp)
        self.children_right = np.empty(node_count, dtype=np.intp)
        self.feature = np.empty(node_count, dtype=np.intp)
        self.threshold = np.empty(node_count, dtype=np.float64)
        self.impurity = np.empty(node_count, dtype=np.float64)
        self.n_node_samples = np.empty(node_count, dtype=np.intp)
        self.weighted_n_node_samples = np.empty(node_count, dtype=np.float64)
        self.missing_go_to_left = np.empty(node_count, dtype=np.uint8)
        self.value = np.empty((node_count, 1, n_classes), dtype=np.float64)

    def apply(self, X: np.ndarray) -> np.ndarray:
        """The leaf each row of the float32 array X reaches."""
        X = np.ascontiguousarray(X)
        if X.dtype != np.float32:
            raise ValueError(f"X.dtype should be np.float32, got {X.dtype}")
        out = np.empty(X.shape[0], dtype=np.intp)
        load().vitae_tree_apply(
            self.children_left.ctypes.data, self.children_right.ctypes.data, self.feature.ctypes.data,
            self.threshold.ctypes.data, self.missing_go_to_left.ctypes.data, X.ctypes.data, X.shape[0],
            X.shape[1], out.ctypes.data)
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        """The value of the leaf each row reaches, (n_rows, n_classes)."""
        return self.value.take(self.apply(X), axis=0, mode="clip").reshape(X.shape[0], self.n_classes)


def build_tree(X: np.ndarray, y: np.ndarray, sample_weight: Optional[np.ndarray], n_classes: int, criterion: str,
               max_features: int, max_depth: int, min_samples_split: int, min_samples_leaf: int,
               min_weight_leaf: float, min_impurity_decrease: float, rand_r_state: int) -> Tree:
    """Grow one tree on float32 rows X, the encoded classes y (float64,
    0 .. n_classes - 1) and the row weights (float64, or None for all 1),
    the splitter seeded with `rand_r_state`."""
    X = np.ascontiguousarray(X)
    if X.dtype != np.float32 or X.ndim != 2:
        raise ValueError(f"X should be a 2-d float32 array, got {X.dtype} of shape {X.shape}")
    y = np.ascontiguousarray(y, dtype=np.float64)
    if sample_weight is not None:
        sample_weight = np.ascontiguousarray(sample_weight, dtype=np.float64)
    if criterion not in CRITERIA:
        raise ValueError(f"criterion {criterion!r} is not one of {sorted(CRITERIA)}")
    lib = load()
    node_count, depth = ctypes.c_int64(0), ctypes.c_int64(0)
    handle = lib.vitae_tree_build(
        X.ctypes.data, X.shape[0], X.shape[1], y.ctypes.data,
        None if sample_weight is None else sample_weight.ctypes.data, n_classes, CRITERIA[criterion],
        max_features, max_depth, min_samples_split, min_samples_leaf, min_weight_leaf, min_impurity_decrease,
        rand_r_state, ctypes.byref(node_count), ctypes.byref(depth))
    if not handle:
        raise MemoryError("tree: out of memory")
    try:
        tree = Tree(node_count.value, n_classes, depth.value)
        lib.vitae_tree_copy(handle, *(getattr(tree, name).ctypes.data for name in (
            "children_left", "children_right", "feature", "threshold", "impurity", "n_node_samples",
            "weighted_n_node_samples", "missing_go_to_left", "value")))
    finally:
        lib.vitae_tree_free(handle)
    return tree


def simultaneous_sort(values: np.ndarray, indices: np.ndarray, three_way: bool = True) -> None:
    """sklearn/utils/_sorting.pyx `simultaneous_sort` in place on a float32
    array and its intp indices (the splitter's sort, for the tests)."""
    if values.dtype != np.float32 or indices.dtype != np.intp or values.shape != indices.shape:
        raise ValueError("simultaneous_sort takes float32 values and intp indices of one length")
    if not (values.flags.c_contiguous and indices.flags.c_contiguous):
        raise ValueError("simultaneous_sort sorts contiguous arrays in place")
    load().vitae_simultaneous_sort_f32(values.ctypes.data, indices.ctypes.data, values.shape[0], int(three_way))
