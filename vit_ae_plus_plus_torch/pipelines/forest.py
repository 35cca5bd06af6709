"""scikit-learn 1.9.0's random forest classifier and the decision tree it
grows, for `eval-classical --method rf`, on the port's copy of sklearn's
tree builder (utils/tree.py over native/tree/).

The GPU machine has no scikit-learn; these give sklearn's numbers bit for
bit on dense rows without missing values, for one output:

- `DecisionTreeClassifier` (sklearn/tree/_classes.py `_fit`, at the
  defaults the forest keeps): X cast to float32, classes encoded by
  `np.unique`, the best splitter seeded with
  `RandomState(random_state).randint(0, 2**31 - 1)`, `max_features`
  "sqrt" as max(1, int(sqrt(n_features))) (27 at width 768), unlimited
  depth (int32 max), min_samples_split 2, min_samples_leaf 1, no minimum
  weight or impurity decrease; `predict_proba` returns the leaves' class
  fractions as they are.
- `RandomForestClassifier` (sklearn/ensemble/_forest.py): y encoded by
  `np.unique` and held as float64; one seed a tree,
  `RandomState(random_state).randint(iinfo(int32).max)` in tree order,
  which seeds both the tree's bootstrap and its splitter; n rows drawn with
  replacement, passed to the tree as row counts. With
  `class_weight="balanced"` the balanced weights of all rows are the
  bootstrap's probabilities (`RandomState(seed).choice(n, n, p=w / w.sum())`)
  and the tree gets the plain counts; with `"balanced_subsample"` the rows
  are `RandomState(seed).randint(0, n, n)` and the counts are multiplied
  by the weights balanced over that bootstrap; with None, the plain
  bootstrap and counts. `predict_proba` adds the trees' outputs in tree
  order into float64 and divides by the number of trees; `predict` is the
  class of the largest, `score` the accuracy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from vit_ae_plus_plus_torch.utils import tree as _tree
from vit_ae_plus_plus_torch.utils.class_weight import compute_class_weight_balanced, compute_sample_weight_balanced

RAND_R_MAX = 2147483647  # sklearn/utils/_random.pxd
MAX_INT = np.iinfo(np.int32).max


def _as_float32_rows(X) -> np.ndarray:
    X = np.asarray(X, dtype=np.float32)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2-d array of rows, got shape {X.shape}")
    if np.isinf(X).any():
        raise ValueError("Input X contains infinity or a value too large for dtype('float32').")
    if np.isnan(X).any():
        raise NotImplementedError("missing values (NaN) in X: the tree builder's missing-value path is not ported")
    return X


def _max_features(max_features, n_features: int) -> int:
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n_features)))
    if max_features is None:
        return n_features
    raise NotImplementedError(f"max_features={max_features!r}: only 'sqrt' and None are ported")


class DecisionTreeClassifier:
    """sklearn's `DecisionTreeClassifier(criterion=..., max_features=...,
    random_state=...)` at its other defaults, for one output: fit /
    apply / predict_proba, with `tree_` (utils/tree.py `Tree`),
    `classes_`, `n_classes_` and `max_features_`."""

    def __init__(self, criterion: str = "gini", max_features=None, random_state=None):
        self.criterion, self.max_features, self.random_state = criterion, max_features, random_state

    def fit(self, X, y, sample_weight=None) -> "DecisionTreeClassifier":
        X = _as_float32_rows(X)
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1:
            raise NotImplementedError("trees of more than one output are not ported")
        if y.shape[0] != X.shape[0]:
            raise ValueError(f"Number of labels={y.shape[0]} does not match number of samples={X.shape[0]}")
        if sample_weight is not None:
            sample_weight = np.asarray(sample_weight, dtype=np.float64)
            if sample_weight.shape != (X.shape[0],):
                raise ValueError(f"sample_weight.shape == {sample_weight.shape}, expected ({X.shape[0]},)")
        # the splitter draws its rand_r seed from the tree's own RandomState
        rand_r_state = check_random_state(self.random_state).randint(0, RAND_R_MAX)
        classes, y_encoded = np.unique(y, return_inverse=True)
        return self._grow(X, classes, y_encoded.astype(np.float64), sample_weight, int(rand_r_state))

    def _grow(self, X: np.ndarray, classes: np.ndarray, y_encoded: np.ndarray, sample_weight: Optional[np.ndarray],
              rand_r_state: int) -> "DecisionTreeClassifier":
        """Grow the tree on float32 rows X and the float64 classes y_encoded
        (indices into `classes`)."""
        self.classes_, self.n_classes_ = classes, classes.shape[0]
        self.n_features_in_ = X.shape[1]
        self.max_features_ = _max_features(self.max_features, self.n_features_in_)
        self.tree_ = _tree.build_tree(
            X, y_encoded, sample_weight, self.n_classes_, self.criterion, self.max_features_, max_depth=MAX_INT,
            min_samples_split=2, min_samples_leaf=1, min_weight_leaf=0.0, min_impurity_decrease=0.0,
            rand_r_state=rand_r_state)
        return self

    def apply(self, X) -> np.ndarray:
        return self.tree_.apply(_as_float32_rows(X))

    def predict_proba(self, X, check_input: bool = True) -> np.ndarray:
        if check_input:
            X = _as_float32_rows(X)
        return self.tree_.predict(X)[:, : self.n_classes_]


def check_random_state(seed) -> np.random.RandomState:
    """sklearn's `check_random_state` for None (numpy's global
    RandomState) or an integer (a new one seeded with it)."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        return np.random.RandomState(seed)
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def _bootstrap_indices(rng: np.random.RandomState, n_samples: int, sample_weight: Optional[np.ndarray]) -> np.ndarray:
    """sklearn/ensemble/_forest.py `_generate_sample_indices` with `rng`
    freshly seeded with the tree's seed: n rows drawn with replacement,
    uniformly or with probabilities w / w.sum()."""
    if sample_weight is None:
        indices = rng.randint(0, n_samples, n_samples)
    else:
        indices = rng.choice(n_samples, n_samples, replace=True, p=sample_weight / np.sum(sample_weight))
    return indices.astype(np.int32)


class RandomForestClassifier:
    """sklearn's `RandomForestClassifier(n_estimators, criterion,
    class_weight, random_state)` at its other defaults (bootstrap,
    max_features "sqrt", sequential trees): fit / predict_proba / predict /
    score, with `estimators_`, `classes_` and `n_classes_`."""

    _PARAMS = ("n_estimators", "criterion", "class_weight", "random_state")

    def __init__(self, n_estimators: int = 100, criterion: str = "gini", class_weight=None, random_state=None):
        self.n_estimators, self.criterion = n_estimators, criterion
        self.class_weight, self.random_state = class_weight, random_state

    def get_params(self) -> Dict:
        return {k: getattr(self, k) for k in self._PARAMS}

    def set_params(self, **params) -> "RandomForestClassifier":
        for k, v in params.items():
            if k not in self._PARAMS:
                raise ValueError(f"invalid parameter {k!r} for RandomForestClassifier")
            setattr(self, k, v)
        return self

    def fit(self, X, y) -> "RandomForestClassifier":
        X = _as_float32_rows(X)
        y = np.asarray(y)
        if y.ndim == 2 and y.shape[1] == 1:
            y = y[:, 0]
        if y.ndim != 1 or y.shape[0] != X.shape[0]:
            raise ValueError(f"X of shape {X.shape} and y of shape {y.shape} do not match")
        if self.class_weight not in (None, "balanced", "balanced_subsample"):
            raise NotImplementedError(f"class_weight={self.class_weight!r}: only None, 'balanced' and "
                                      "'balanced_subsample' are ported")
        self.classes_, y_encoded = np.unique(y, return_inverse=True)
        self.n_classes_ = self.classes_.shape[0]
        # the balanced weights of all rows draw the bootstrap; with
        # "balanced_subsample" they are computed on each bootstrap instead
        sample_weight = None
        if self.class_weight == "balanced":
            weight = compute_class_weight_balanced(self.classes_, y)
            sample_weight = weight[y_encoded]
        y_enc = np.ascontiguousarray(y_encoded, dtype=np.float64)
        tree_classes = np.arange(self.n_classes_, dtype=np.float64)  # np.unique of y_enc
        n_samples = X.shape[0]
        random_state = check_random_state(self.random_state)
        seeds = [random_state.randint(MAX_INT) for _ in range(self.n_estimators)]
        # RandomState(seed) costs ~0.2 ms (its MT19937 is first seeded from
        # the OS); reseeding one instance gives the same streams
        rng = np.random.RandomState()
        self.estimators_ = []
        for seed in seeds:
            rng.seed(seed)
            indices = _bootstrap_indices(rng, n_samples, sample_weight)
            sample_weight_tree = np.bincount(indices, minlength=n_samples)
            if self.class_weight == "balanced_subsample":
                sample_weight_tree = sample_weight_tree * compute_sample_weight_balanced(y_enc, indices=indices)
            rng.seed(seed)  # the tree's own RandomState(seed) seeds its splitter
            tree = DecisionTreeClassifier(criterion=self.criterion, max_features="sqrt", random_state=int(seed))
            self.estimators_.append(tree._grow(X, tree_classes, y_enc, sample_weight_tree,
                                               int(rng.randint(0, RAND_R_MAX))))
        return self

    def predict_proba(self, X) -> np.ndarray:
        X = _as_float32_rows(X)
        proba = np.zeros((X.shape[0], self.n_classes_), dtype=np.float64)
        for tree in self.estimators_:
            proba += tree.predict_proba(X, check_input=False)
        proba /= len(self.estimators_)
        return proba

    def predict(self, X) -> np.ndarray:
        return self.classes_.take(np.argmax(self.predict_proba(X), axis=1), axis=0)

    def score(self, X, y) -> float:
        """Accuracy, as sklearn's `ClassifierMixin.score`."""
        return float(np.average(np.asarray(y) == self.predict(X)))
