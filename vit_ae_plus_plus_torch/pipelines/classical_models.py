"""Classical models on extracted SSL features: the SVM and its search.

The port's counterpart of the JAX package's pipelines/classical_models.py
(reference bootstrap/utils/classical_models.py:12-103), which fits
`sklearn.svm.SVC(probability=True, random_state=42,
class_weight="balanced")` inside `RandomizedSearchCV(..., random_state=42)`
and returns `predict_proba` on the test features. The GPU machine has no
scikit-learn, so this module carries what that path runs of it, on the
port's copy of sklearn's libsvm (utils/libsvm.py), and gives sklearn
1.9.0's numbers:

- `SVC`: sklearn/svm/_base.py and _classes.py for the dense C-SVC with
  the reference's settings (`class_weight="balanced"`, every other one at
  sklearn's default). Classes are encoded by `np.unique`; the balanced
  weights are n / (k * bincount); `gamma="scale"` is 1 / (n_features *
  X.var()) on float64 X;
  libsvm's seed is `RandomState(random_state).randint(iinfo("i").max)`;
  with two classes `intercept_`, `dual_coef_` and `decision_function`
  carry the flipped sign; `predict` goes through libsvm's decision values,
  not the probabilities;
- `RandomizedSearchCV`: for grids of lists, as these are
  (sklearn/model_selection/_search.py `ParameterSampler`, `ParameterGrid`,
  sklearn/utils/_random.pyx `sample_without_replacement` as "auto" picks
  its method); 5-fold `StratifiedKFold` without shuffling
  (data/splits.py `stratified_kfold`); accuracy as the score; a fit that
  raises `ValueError` scores NaN, as `error_score=np.nan` does, and the
  search raises when every fit failed; `rankdata(-mean, "min")` with NaN
  means ranked last (all ranked 1 when every mean is NaN); the first best
  is refitted on all the rows.

Only the SVM is ported. The random forest (sklearn's Cython tree-growing code
with its own RNG) and the logistic regression (four solvers, one of them
Cython) raise `NotImplementedError` before any fit: ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import itertools
import warnings
from typing import Dict, List

import numpy as np
from scipy.stats import rankdata

from vit_ae_plus_plus_torch.data.splits import stratified_kfold
from vit_ae_plus_plus_torch.utils import libsvm

PARAM_GRIDS = {
    "svm": {"C": [0.1, 1, 5, 10], "kernel": ["linear", "rbf"]},
    "rf": {
        "n_estimators": [50, 100, 150, 200],
        "criterion": ["gini", "entropy"],
        "class_weight": ["balanced", "balanced_subsample"],
    },
    "linear": {
        "solver": ["newton-cg", "lbfgs", "liblinear", "sag"],
        "penalty": ["l2", None],
        "max_iter": [200, 500, 1000],
    },
}
# RandomizedSearchCV's defaults, which the reference keeps
N_ITER, CV = 10, 5


class SVC:
    """sklearn's `SVC(C, kernel, probability=..., random_state=...,
    class_weight="balanced")` for dense input, at the rest of sklearn's
    defaults (libsvm.py's constants, gamma "scale"): fit / predict /
    predict_proba / score, and decision_function for two classes."""

    def __init__(self, C: float = 1.0, kernel: str = "rbf", probability: bool = False, random_state=None):
        self.C, self.kernel, self.probability, self.random_state = C, kernel, probability, random_state

    def get_params(self) -> Dict:
        return {k: getattr(self, k) for k in ("C", "kernel", "probability", "random_state")}

    def set_params(self, **params) -> "SVC":
        for k, v in params.items():
            if k not in self.get_params():
                raise ValueError(f"invalid parameter {k!r} for SVC")
            setattr(self, k, v)
        return self

    def fit(self, X, y) -> "SVC":
        X = np.ascontiguousarray(X, dtype=np.float64)
        y = np.asarray(y).ravel()
        if X.ndim != 2 or X.shape[0] != y.shape[0]:
            raise ValueError(f"X of shape {X.shape} and y of {y.shape[0]} labels do not match")
        rnd = np.random.RandomState(self.random_state)
        classes, y_enc = np.unique(y, return_inverse=True)
        # sklearn/utils/class_weight.py compute_class_weight("balanced")
        counts = np.bincount(y_enc, weights=np.ones(y.shape[0], dtype=np.float64))
        self.class_weight_ = np.sum(counts) / (classes.shape[0] * counts)
        if len(classes) < 2:
            raise ValueError(f"The number of classes has to be greater than one; got {len(classes)} class")
        self.classes_ = classes
        x_var = X.var()
        self._gamma = 1.0 / (X.shape[1] * x_var) if x_var != 0 else 1.0  # gamma="scale"
        seed = rnd.randint(np.iinfo("i").max)
        (self.support_, self.support_vectors_, self._n_support, self._dual_coef_, self._intercept_,
         self._probA, self._probB) = libsvm.fit(
            X, np.asarray(y_enc, dtype=np.float64), kernel=self.kernel, gamma=self._gamma, C=self.C,
            class_weight=self.class_weight_, probability=bool(self.probability), random_seed=seed)
        # sklearn keeps libsvm's signs internally and shows the flipped ones
        # for two classes
        self.intercept_, self.dual_coef_ = self._intercept_.copy(), self._dual_coef_
        if len(classes) == 2:
            self.intercept_ *= -1
            self.dual_coef_ = -self.dual_coef_
        if not (np.isfinite(self._intercept_).all() and np.isfinite(self._dual_coef_).all()):
            raise ValueError("The dual coefficients or intercepts are not finite. The input data may "
                             "contain large values and need to be preprocessed.")
        return self

    def _model(self):
        return (self.support_, self.support_vectors_, self._n_support, self._dual_coef_,
                self._intercept_, self._probA, self._probB)

    def decision_function(self, X) -> np.ndarray:
        dec = libsvm.decision_function(np.ascontiguousarray(X, dtype=np.float64), *self._model(),
                                       kernel=self.kernel, gamma=self._gamma)
        if len(self.classes_) == 2:
            return -dec.ravel()
        # decision_function_shape="ovr" for more classes (sklearn's
        # _ovr_decision_function) is not needed by any caller
        raise NotImplementedError("decision_function for more than two classes is not ported")

    def predict(self, X) -> np.ndarray:
        y = libsvm.predict(np.ascontiguousarray(X, dtype=np.float64), *self._model(), kernel=self.kernel,
                           gamma=self._gamma)
        return self.classes_.take(np.asarray(y, dtype=np.intp))

    def predict_proba(self, X) -> np.ndarray:
        if not self.probability:
            raise AttributeError("predict_proba is not available when probability=False")
        return libsvm.predict_proba(np.ascontiguousarray(X, dtype=np.float64), *self._model(),
                                    kernel=self.kernel, gamma=self._gamma)

    def score(self, X, y) -> float:
        """Accuracy, as sklearn's `ClassifierMixin.score`."""
        return float(np.average(np.asarray(y) == self.predict(X)))


def parameter_grid(grid: Dict[str, list]) -> List[Dict]:
    """sklearn's `ParameterGrid(grid)` as a list: the product over the
    sorted keys, the last key varying fastest."""
    keys = sorted(grid)
    return [dict(zip(keys, values)) for values in itertools.product(*(grid[k] for k in keys))]


def sample_without_replacement(n_population: int, n_samples: int, rng: np.random.RandomState) -> np.ndarray:
    """sklearn/utils/_random.pyx `sample_without_replacement` with
    method="auto", for ratios above 0.01: a permutation's head for a ratio
    below 0.99, reservoir sampling above (the SVM grid's 8 of 8). Smaller
    ratios, where "auto" picks tracking selection, need a grid of more than
    N_ITER / 0.01 points, which no grid here has."""
    if n_samples > n_population:
        raise ValueError(f"n_samples > n_population ({n_samples} > {n_population})")
    ratio = n_samples / n_population if n_population != 0 else 1.0
    if ratio <= 0.01:
        raise NotImplementedError(f"sampling {n_samples} of {n_population}: tracking selection is not ported")
    if ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.arange(n_samples)
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def sample_parameters(grid: Dict[str, list], random_state: int) -> List[Dict]:
    """sklearn's `ParameterSampler(grid, N_ITER, random_state)` for a grid
    of lists: min(N_ITER, grid size) points drawn without replacement."""
    points = parameter_grid(grid)
    n = min(N_ITER, len(points))
    if n < N_ITER:
        warnings.warn(f"The total space of parameters {len(points)} is smaller than n_iter={N_ITER}. "
                      f"Running {n} iterations. For exhaustive searches, use GridSearchCV.", UserWarning)
    rng = np.random.RandomState(random_state)
    return [points[i] for i in sample_without_replacement(len(points), n, rng)]


class RandomizedSearchCV:
    """sklearn's `RandomizedSearchCV(estimator, grid, random_state=...)`
    at its defaults (N_ITER candidates, CV folds, refit) for a classifier
    and a grid of lists, scored by accuracy. After `fit`: `cv_results_`
    (params, split{k}_test_score, mean_test_score, std_test_score,
    rank_test_score), `best_index_`, `best_params_`, `best_score_` and the
    refitted `best_estimator_`."""

    def __init__(self, estimator, param_distributions: Dict[str, list], random_state=None):
        self.estimator, self.param_distributions, self.random_state = estimator, param_distributions, random_state

    def _clone(self, params: Dict):
        return type(self.estimator)(**self.estimator.get_params()).set_params(**params)

    def fit(self, X, y) -> "RandomizedSearchCV":
        X, y = np.asarray(X), np.asarray(y)
        candidates = sample_parameters(self.param_distributions, self.random_state)
        splits = stratified_kfold(y, CV)
        scores = np.empty((len(candidates), len(splits)))
        for i, params in enumerate(candidates):
            for k, (train, test) in enumerate(splits):
                try:
                    est = self._clone(params).fit(X[train], y[train])
                except ValueError as e:  # error_score=np.nan
                    warnings.warn(f"fit failed for {params} on split {k}: {e}", UserWarning)
                    scores[i, k] = np.nan
                    continue
                scores[i, k] = est.score(X[test], y[test])
        if np.isnan(scores).all():
            raise ValueError(f"All the {scores.size} fits failed.")
        means = np.average(scores, axis=1)
        stds = np.sqrt(np.average((scores - means[:, np.newaxis]) ** 2, axis=1))
        if np.isnan(means).all():  # every candidate failed on some split
            ranks = np.ones_like(means, dtype=np.int32)
        else:
            ranked = np.where(np.isnan(means), np.nanmin(means) - 1, means)
            ranks = rankdata(-ranked, method="min").astype(np.int32, copy=False)
        self.cv_results_ = {"params": candidates, "mean_test_score": means, "std_test_score": stds,
                            "rank_test_score": ranks,
                            **{f"split{k}_test_score": scores[:, k] for k in range(len(splits))}}
        self.best_index_ = int(ranks.argmin())
        self.best_params_ = candidates[self.best_index_]
        self.best_score_ = float(means[self.best_index_])
        self.best_estimator_ = self._clone(self.best_params_).fit(X, y)
        return self

    def predict_proba(self, X) -> np.ndarray:
        return self.best_estimator_.predict_proba(X)


def _estimator(method: str) -> SVC:
    if method == "svm":
        return SVC(probability=True, random_state=42)
    if method in PARAM_GRIDS:
        raise NotImplementedError(
            f"eval-classical --method {method}: only svm is ported; {method} is the next part of "
            "ROADMAP Queue 1 item 3")
    raise ValueError(f"invalid method {method!r}")


def check_methods(*methods: str) -> None:
    """Raise before any file is read for a method that is not ported."""
    for method in methods:
        _estimator(method)


def execute_models(train_features: np.ndarray, train_label: np.ndarray, test_features: np.ndarray,
                   *methods: str) -> Dict[str, np.ndarray]:
    """Fit each method with the search and return `predict_proba` on the
    test features (classical_models.py:96-103)."""
    check_methods(*methods)
    results = {}
    for method in methods:
        grid = RandomizedSearchCV(_estimator(method), PARAM_GRIDS[method], random_state=42)
        grid.fit(train_features, train_label)
        results[method] = grid.predict_proba(test_features)
    return results
