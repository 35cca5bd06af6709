"""scikit-learn's binary logistic regression for the classical evaluation.

The reference's search fits `sklearn.linear_model.LogisticRegression(
random_state=42, class_weight="balanced")` over the solvers newton-cg,
lbfgs, liblinear and sag, penalty l2 or None and max_iter 200, 500 or 1000
(pipelines/classical_models.py PARAM_GRIDS["linear"]). The GPU machine has
no scikit-learn, so this module is the port's copy of what those fits run
(sklearn/linear_model/_logistic.py `LogisticRegression.fit` and
`_logistic_regression_path`, scikit-learn 1.9.0), for two classes and dense
input, giving scikit-learn's numbers:

- the features keep their dtype when it is float32 or float64 (anything
  else becomes float64), as the feature dumps' float32 does there;
- penalty=None is C = inf; liblinear refuses it (`ValueError`);
- the balanced class weights n / (k * bincount) multiply the sample weights
  (in X's dtype), and the l2 strength of lbfgs and newton-cg is
  1 / (C * sum of the weights);
- lbfgs: scipy's L-BFGS-B (public scipy) on `LinearModelLoss.loss_gradient`
  with sklearn's options, from float32 zeros for float32 X;
- newton-cg: utils/optimize.py `_newton_cg` on the loss, its gradient and
  its Hessian product;
- liblinear: utils/liblinear.py `fit_liblinear`, the intercept a
  regularised bias column, coef_ in float64;
- sag: utils/sag.py `sag_solver` with alpha = 1 / C and the largest
  squared row norm;
- `decision_function` X @ coef_.T + intercept_, `predict` its sign,
  `predict_proba` [1 - expit, expit], `score` the accuracy.

`class_weight="balanced"` is fixed, as the port's `SVC` fixes it. More than
two classes raise `NotImplementedError`: no caller passes them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy
from scipy import optimize
from scipy.special import expit

from vit_ae_plus_plus_torch.utils import liblinear, sag
from vit_ae_plus_plus_torch.utils.class_weight import compute_class_weight_balanced
from vit_ae_plus_plus_torch.utils.linear_loss import LinearModelLoss
from vit_ae_plus_plus_torch.utils.optimize import _check_optimize_result, _newton_cg

SOLVERS = ("lbfgs", "liblinear", "newton-cg", "sag")


def _check_solver(solver: str, penalty) -> str:
    """sklearn's `_check_solver` for the ported solvers and penalties."""
    if solver not in SOLVERS:
        raise ValueError(f"solver must be one of {SOLVERS}, got {solver!r}")
    if penalty not in ("l2", None):
        raise ValueError(f"Solver {solver} supports only 'l2' or None penalties, got {penalty} penalty.")
    if solver == "liblinear" and penalty is None:
        raise ValueError("C=np.inf as well as penalty=None is not supported for the liblinear solver")
    return solver


def _lbfgs_options(max_iter: int, tol: float) -> Dict:
    """sklearn's L-BFGS-B options; scipy before 1.15 takes iprint=-1 to keep
    quiet, later ones deprecate it (sklearn/utils/fixes.py)."""
    options = {"maxiter": max_iter, "maxls": 50, "gtol": tol, "ftol": 64 * np.finfo(float).eps}
    if tuple(int(p) for p in scipy.__version__.split(".")[:2]) < (1, 15):
        options["iprint"] = -1
    return options


class LogisticRegression:
    """sklearn's `LogisticRegression(penalty, solver=..., max_iter=...,
    random_state=..., class_weight="balanced")` for two classes, at the rest
    of its defaults (C=1, tol=1e-4, an intercept, intercept_scaling=1):
    fit / decision_function / predict / predict_proba / score, and
    `classes_`, `coef_` (1, n_features), `intercept_` (1,) and `n_iter_`
    (1,) after `fit`."""

    def __init__(self, penalty="l2", solver: str = "lbfgs", max_iter: int = 100, random_state=None):
        self.penalty, self.solver, self.max_iter, self.random_state = penalty, solver, max_iter, random_state

    C, tol, intercept_scaling = 1.0, 1e-4, 1.0

    def get_params(self) -> Dict:
        return {k: getattr(self, k) for k in ("penalty", "solver", "max_iter", "random_state")}

    def set_params(self, **params) -> "LogisticRegression":
        for k, v in params.items():
            if k not in self.get_params():
                raise ValueError(f"invalid parameter {k!r} for LogisticRegression")
            setattr(self, k, v)
        return self

    def fit(self, X, y) -> "LogisticRegression":
        solver = _check_solver(self.solver, self.penalty)
        # penalty=None: no penalty, C = inf, then the l2 code path
        C = np.inf if self.penalty is None else self.C
        X = np.asarray(X)
        if X.dtype not in (np.float64, np.float32):
            X = X.astype(np.float64)
        X = np.ascontiguousarray(X)
        y = np.asarray(y).ravel()
        if X.ndim != 2 or X.shape[0] != y.shape[0]:
            raise ValueError(f"X of shape {X.shape} and y of {y.shape[0]} labels do not match")
        self.classes_ = np.unique(y)
        n_classes = len(self.classes_)
        if n_classes > 2:
            raise NotImplementedError(f"LogisticRegression for {n_classes} classes is not ported: only two")
        if solver == "liblinear":
            if np.max(X) > 1e30:
                raise ValueError("Using the 'liblinear' solver while X contains a maximum value > 1e30 results "
                                 "in a frozen fit. Please choose another solver or rescale the input X.")
            self.coef_, self.intercept_, self.n_iter_ = liblinear.fit_liblinear(
                X, y, self.C, self.intercept_scaling, self.max_iter, self.tol, self.random_state)
            return self
        max_squared_sum = np.einsum("ij,ij->i", X, X).max() if solver == "sag" else None
        if n_classes < 2:
            raise ValueError("This solver needs samples of at least 2 classes in the data, but the data "
                             f"contains only one class: {self.classes_[0]!r}")
        w0, n_iter = self._path(X, y, C, solver, max_squared_sum)
        coef = np.asarray(w0.copy(order="K"), dtype=X.dtype)
        self.n_iter_ = np.asarray([n_iter], dtype=np.int32)
        self.intercept_, self.coef_ = coef[-1:], coef[:-1][None, :]
        return self

    def _path(self, X, y, C, solver, max_squared_sum):
        """`_logistic_regression_path(X, y, Cs=[C], ...)` for two classes
        -> (w with the intercept last, iterations)."""
        rnd = np.random.RandomState(self.random_state)
        n_samples, n_features = X.shape
        # sklearn/utils/class_weight.py compute_class_weight("balanced"), its
        # float64 weights cast to X's dtype, times unit sample weights
        y_ind = np.searchsorted(self.classes_, y)
        class_weight_ = compute_class_weight_balanced(self.classes_, y)[y_ind]
        sample_weight = np.ones(n_samples, dtype=X.dtype)
        sample_weight *= np.asarray(class_weight_, dtype=X.dtype)
        w0 = np.zeros(n_features + 1, dtype=X.dtype)
        # HalfBinomialLoss's y in [0, 1]: classes_[1] is the positive label
        y_bin = np.ones(y.shape, dtype=X.dtype)
        y_bin[~(y == self.classes_[1])] = 0.0
        loss = LinearModelLoss()
        if solver in ("lbfgs", "newton-cg"):
            sw_sum = float(np.sum(sample_weight))
            l2_reg_strength = 1.0 / (C * sw_sum)
            args = (X, y_bin, sample_weight, l2_reg_strength)
        if solver == "lbfgs":
            opt_res = optimize.minimize(loss.loss_gradient, w0, method="L-BFGS-B", jac=True, args=args,
                                        options=_lbfgs_options(self.max_iter, self.tol))
            return opt_res.x, _check_optimize_result(opt_res, self.max_iter)
        if solver == "newton-cg":
            return _newton_cg(grad_hess=loss.gradient_hessian_product, func=loss.loss, grad=loss.gradient,
                              x0=w0, args=args, maxiter=self.max_iter, tol=self.tol)
        return sag.sag_solver(X, y_bin, sample_weight, 1.0 / C, self.max_iter, self.tol, rnd, max_squared_sum)

    def decision_function(self, X) -> np.ndarray:
        X = np.asarray(X)
        scores = X @ self.coef_.T + self.intercept_
        return scores.reshape(-1)

    def predict(self, X) -> np.ndarray:
        return self.classes_.take((self.decision_function(X) > 0).astype(np.intp), axis=0)

    def predict_proba(self, X) -> np.ndarray:
        prob = self.decision_function(X)
        prob = expit(prob, out=prob)
        return np.stack([1 - prob, prob], axis=1)

    def score(self, X, y) -> float:
        """Accuracy, as sklearn's `ClassifierMixin.score`."""
        return float(np.average(np.asarray(y) == self.predict(X)))
