"""The port's logistic regression (`eval-classical --method linear`) against
scikit-learn 1.9.0 and the JAX package, on the CPU.

- `LogisticRegression` (pipelines/logistic.py) against
  `sklearn.linear_model.LogisticRegression(random_state=42,
  class_weight="balanced", ...)` at each of the 10 grid points the search
  samples from the linear grid, plus liblinear / l2 / 200 and sag / l2 /
  200, on the imbalanced 40 x 32 and the balanced 24 x 768 problems of
  test_torch_port_eval_classical.py, in float32 (as the feature dumps
  hold them) and float64: `coef_`, `intercept_`, `n_iter_` (dtypes and
  shapes too), `decision_function`, `predict` and `predict_proba` on
  held-out rows, all equal bit for bit.
- The half binomial loss's per-sample loops (native/sag/loss.h) against
  scikit-learn's `HalfBinomialLoss` over every branch of its closed forms,
  with and without sample weights, bit for bit; the port's copy of scipy's
  line searches against scipy's own.
- liblinear with penalty=None raises `ValueError` on both sides; more than
  two classes raise `NotImplementedError`; the libraries refuse to build
  without g++, and an unexpected BLAS signature raises.
- The search over the linear grid against scikit-learn's: the candidates in
  order, every split's score, `mean_test_score`, `rank_test_score`,
  `best_params_` and `predict_proba` after the refit.
- `evaluate_features(method="linear")` against the JAX package's on a
  seeded feature directory with 2 folds (the dicts and the printed lines),
  and the CLI's summary as its last line.
"""

import json
import warnings

import numpy as np
import pytest
from scipy.optimize import _linesearch as sp_linesearch
from sklearn._loss.loss import HalfBinomialLoss as SkHalfBinomialLoss
from sklearn.exceptions import ConvergenceWarning as SkConvergenceWarning
from sklearn.linear_model import LogisticRegression as SkLogisticRegression
from sklearn.model_selection import RandomizedSearchCV as SkRandomizedSearchCV
from threadpoolctl import threadpool_limits

from vit_ae_plus_plus_tpu.pipelines import eval_classical as jec
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.pipelines import classical_models as cm
from vit_ae_plus_plus_torch.pipelines import eval_classical as tec
from vit_ae_plus_plus_torch.pipelines.logistic import LogisticRegression
from vit_ae_plus_plus_torch.utils import liblinear, optimize, sag
from vit_ae_plus_plus_torch.utils.linear_loss import HalfBinomialLoss


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    # the fits are small: BLAS threads only contend with the other test
    # workers (both sides run under the same limit)
    with threadpool_limits(limits=1):
        yield


@pytest.fixture(autouse=True)
def quiet():
    # sklearn 1.9 deprecates `penalty` with a FutureWarning; sag and lbfgs
    # at their limits warn ConvergenceWarning (checked where it matters)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", UserWarning)
        yield


def _problem(name: str):
    """(X, y, X_test) in f32, as test_torch_port_eval_classical.py makes them."""
    if name == "imbalanced":
        rng = np.random.default_rng(0)
        n, d, n_pos = 40, 32, 11
    else:
        rng = np.random.default_rng(1)
        n, d, n_pos = 24, 768, 12
    y = np.zeros(n, dtype=np.int64)
    y[rng.permutation(n)[:n_pos]] = 1
    X = rng.standard_normal((n, d)).astype(np.float32) + 0.3 * y[:, None].astype(np.float32)
    X_test = rng.standard_normal((12, d)).astype(np.float32) + 0.3 * (np.arange(12) % 2)[:, None]
    return X, y, X_test.astype(np.float32)


PROBLEMS = ("imbalanced", "balanced")
# the search's 10 points of the linear grid, in its order, then liblinear
# and sag at max_iter 200
POINTS = [("newton-cg", "l2", 500), ("newton-cg", "l2", 1000), ("newton-cg", "l2", 200),
          ("liblinear", "l2", 1000), ("sag", "l2", 500), ("lbfgs", "l2", 500), ("lbfgs", None, 500),
          ("lbfgs", "l2", 200), ("lbfgs", None, 1000), ("lbfgs", None, 200),
          ("liblinear", "l2", 200), ("sag", "l2", 200)]


def test_the_points_are_the_searchs():
    sampled = cm.sample_parameters(cm.PARAM_GRIDS["linear"], 42)
    assert [(p["solver"], p["penalty"], p["max_iter"]) for p in sampled] == POINTS[:10]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("solver,penalty,max_iter", POINTS)
def test_logistic_regression_matches_sklearn_bitwise(solver, penalty, max_iter, problem, dtype):
    X, y, X_test = (a.astype(dtype) if a.dtype.kind == "f" else a for a in _problem(problem))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SkConvergenceWarning)
        want = SkLogisticRegression(random_state=42, class_weight="balanced", solver=solver, penalty=penalty,
                                    max_iter=max_iter).fit(X, y)
        got = LogisticRegression(random_state=42, solver=solver, penalty=penalty, max_iter=max_iter).fit(X, y)
    for attr in ("coef_", "intercept_", "n_iter_", "classes_"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (attr, g, w)
    for method in ("decision_function", "predict", "predict_proba"):
        g, w = getattr(got, method)(X_test), getattr(want, method)(X_test)
        assert g.dtype == w.dtype and np.array_equal(g, w), (method, g, w)
    assert got.score(X_test, np.arange(12) % 2) == want.score(X_test, np.arange(12) % 2)


def test_convergence_warnings_match_sklearn():
    X, y, _ = _problem("balanced")
    for solver, penalty in (("sag", None), ("lbfgs", "l2"), ("liblinear", "l2"), ("newton-cg", "l2")):
        with warnings.catch_warnings(record=True) as want:
            warnings.simplefilter("always")
            SkLogisticRegression(random_state=42, class_weight="balanced", solver=solver, penalty=penalty,
                                 max_iter=1).fit(X, y)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            LogisticRegression(random_state=42, solver=solver, penalty=penalty, max_iter=1).fit(X, y)
        assert any(issubclass(w.category, SkConvergenceWarning) for w in want), solver
        assert any(issubclass(w.category, optimize.ConvergenceWarning) for w in got), solver


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_half_binomial_loss_matches_sklearn_bitwise(dtype):
    """Every branch of the closed forms: raw <= -37, -37..-2, -2..18,
    18..33.3 and above, each side of the cutoffs, y in {0, 1}."""
    rng = np.random.default_rng(7)
    raw = np.concatenate([rng.uniform(-60, 60, 4000), rng.normal(0, 3, 4000),
                          [-37, -37.0001, -2, -2.0001, 18, 18.0001, 33.3, 33.3001, 0.0]]).astype(dtype)
    y = (rng.random(raw.shape[0]) < 0.5).astype(dtype)
    sw = rng.uniform(0.1, 3.0, raw.shape[0]).astype(dtype)
    got, want = HalfBinomialLoss(), SkHalfBinomialLoss()
    for weights in (None, sw):
        pairs = [(got.loss(y, raw, weights), want.loss(y_true=y, raw_prediction=raw, sample_weight=weights)),
                 (got.gradient(y, raw, weights),
                  want.gradient(y_true=y, raw_prediction=raw, sample_weight=weights))]
        pairs += list(zip(got.loss_gradient(y, raw, weights),
                          want.loss_gradient(y_true=y, raw_prediction=raw, sample_weight=weights)))
        pairs += list(zip(got.gradient_hessian(y, raw, weights),
                          want.gradient_hessian(y_true=y, raw_prediction=raw, sample_weight=weights)))
        for k, (g, w) in enumerate(pairs):
            assert g.dtype == w.dtype == dtype and np.array_equal(g, w), (k, weights is None)


def test_line_searches_match_scipys():
    """The copies of scipy's scalar Wolfe searches, on a few smooth
    functions from several starts, give scipy's steps and values."""
    def problems():
        rng = np.random.default_rng(3)
        for _ in range(20):
            a = rng.uniform(0.5, 5.0, 6)
            x0 = rng.normal(0, 2, 6)
            f = lambda x, a=a: float(np.sum(a * x ** 4) + np.sum(x ** 2))
            g = lambda x, a=a: 4 * a * x ** 3 + 2 * x
            yield f, g, x0, -g(x0)

    for f, g, x0, pk in problems():
        phi = lambda s: f(x0 + s * pk)
        derphi = lambda s: g(x0 + s * pk) @ pk
        assert optimize.scalar_search_wolfe1(phi, derphi, c2=0.4) == sp_linesearch.scalar_search_wolfe1(
            phi, derphi, c2=0.4)
        got = optimize.line_search_wolfe2(f, g, x0, pk)
        want = sp_linesearch.line_search_wolfe2(f, g, x0, pk)
        assert got[:5] == want[:5] and np.array_equal(got[5], want[5])


def test_liblinear_refuses_no_penalty_like_sklearn():
    X, y, _ = _problem("imbalanced")
    with pytest.raises(ValueError, match="penalty=None is not supported for the liblinear solver"):
        SkLogisticRegression(random_state=42, class_weight="balanced", solver="liblinear", penalty=None).fit(X, y)
    with pytest.raises(ValueError, match="penalty=None is not supported for the liblinear solver"):
        LogisticRegression(random_state=42, solver="liblinear", penalty=None).fit(X, y)


def test_refusals_and_params():
    X, y, _ = _problem("imbalanced")
    with pytest.raises(NotImplementedError, match="3 classes is not ported"):
        LogisticRegression(random_state=42).fit(X, np.arange(X.shape[0]) % 3)
    with pytest.raises(ValueError, match="only one class"):
        LogisticRegression(random_state=42).fit(X, np.zeros_like(y))
    with pytest.raises(ValueError, match="only one class"):
        LogisticRegression(random_state=42, solver="liblinear").fit(X, np.zeros_like(y))
    est = LogisticRegression(random_state=42)
    assert est.get_params() == {"penalty": "l2", "solver": "lbfgs", "max_iter": 100, "random_state": 42}
    assert est.set_params(solver="sag", max_iter=7).get_params()["solver"] == "sag"
    with pytest.raises(ValueError, match="invalid parameter 'C'"):
        est.set_params(C=2.0)
    with pytest.raises(ValueError, match="C <= 0"):
        liblinear.train_wrap(X, y.astype(np.float64), 0, 1e-4, 1.0, 0.0, np.ones(2), 10, 1, 0.1,
                             np.ones(X.shape[0]))


def test_native_libraries_refuse_unbuilt_compilers_and_odd_blas(monkeypatch, tmp_path):
    monkeypatch.setattr(liblinear, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(sag, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    for module in (liblinear, sag):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            module.build()
    from vit_ae_plus_plus_torch.kernels._build import scipy_blas

    with pytest.raises(RuntimeError, match="dnrm2"):
        scipy_blas("dnrm2", "double (long *, double *, long *)")
    assert scipy_blas("dnrm2", liblinear.BLAS_SIGNATURES["dnrm2"])


@pytest.mark.parametrize("problem", PROBLEMS)
def test_linear_search_matches_sklearn(problem):
    X, y, X_test = _problem(problem)
    est = SkLogisticRegression(random_state=42, class_weight="balanced")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SkConvergenceWarning)
        want = SkRandomizedSearchCV(est, cm.PARAM_GRIDS["linear"], refit=True, random_state=42).fit(X, y)
        got = cm.RandomizedSearchCV(cm._estimator("linear"), cm.PARAM_GRIDS["linear"], random_state=42).fit(X, y)
        probs = cm.execute_models(X, y, X_test, "linear")["linear"]
    assert got.cv_results_["params"] == list(want.cv_results_["params"])
    for key in ("mean_test_score", "std_test_score", "rank_test_score",
                *(f"split{k}_test_score" for k in range(5))):
        g, w = got.cv_results_[key], want.cv_results_[key]
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True), (key, g, w)
    assert got.best_params_ == want.best_params_ and got.best_index_ == want.best_index_
    assert np.array_equal(got.predict_proba(X_test), want.predict_proba(X_test))
    assert np.array_equal(probs, want.predict_proba(X_test))


def test_search_scores_a_refused_fit_nan_like_sklearn():
    """liblinear without a penalty is not among the 10 sampled points; on a
    grid that holds it, both searches score it NaN and rank it last."""
    X, y, _ = _problem("imbalanced")
    grid = {"solver": ["liblinear", "lbfgs"], "penalty": ["l2", None], "max_iter": [200]}
    est = SkLogisticRegression(random_state=42, class_weight="balanced")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = SkRandomizedSearchCV(est, grid, random_state=42).fit(X, y)
        got = cm.RandomizedSearchCV(cm._estimator("linear"), grid, random_state=42).fit(X, y)
    assert got.cv_results_["params"] == list(want.cv_results_["params"])
    for key in ("mean_test_score", "rank_test_score", *(f"split{k}_test_score" for k in range(5))):
        g, w = got.cv_results_[key], want.cv_results_[key]
        assert np.array_equal(g, w, equal_nan=True), (key, g, w)
    assert np.isnan(got.cv_results_["mean_test_score"]).sum() == 1
    assert got.best_params_ == want.best_params_


def test_linear_gate_margins():
    """chip_smoke.py phase 5f (c)'s LINEAR_GATE against its CPU readings, on
    12 seeded stand-ins for 5d's features (rows that share a standard normal
    mean and spread 0.04 a feature around it, the classes 0 or 0.01 apart;
    24 training and 24 test rows of 768 f32 features): lbfgs and newton-cg
    (l2, max_iter=1000) both converge and their predict_proba differ by at
    most a third of the limit, and lbfgs at max_iter=1 misses it by 3x or
    more."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    gates, controls = [], []
    for seed in range(6):
        for apart in (0.0, 0.01):
            rng = np.random.default_rng(seed)
            mean = rng.standard_normal(768)
            y = rng.permutation(np.arange(24) % 2)
            X = (mean + 0.04 * rng.standard_normal((24, 768)) + apart * y[:, None]).astype(np.float32)
            X_test = (mean + 0.04 * rng.standard_normal((24, 768))
                      + apart * (np.arange(24) % 2)[:, None]).astype(np.float32)
            with warnings.catch_warnings():
                warnings.simplefilter("error", optimize.ConvergenceWarning)
                lbfgs = LogisticRegression(random_state=42, solver="lbfgs", max_iter=1000).fit(X, y)
                newton = LogisticRegression(random_state=42, solver="newton-cg", max_iter=1000).fit(X, y)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", optimize.ConvergenceWarning)
                control = LogisticRegression(random_state=42, solver="lbfgs", max_iter=1).fit(X, y)
            want = newton.predict_proba(X_test)
            gates.append(np.abs(lbfgs.predict_proba(X_test) - want).max())
            controls.append(np.abs(control.predict_proba(X_test) - want).max())
    assert max(gates) <= chip_smoke.LINEAR_GATE / 3, max(gates)
    assert min(controls) >= chip_smoke.LINEAR_GATE * 3, min(controls)
    assert f"{max(gates):.2e} {min(controls):.2e}" == "2.12e-03 3.68e-02"


def _feature_dir(root, n_splits: int, seed: int):
    """Per-fold dumps as pretrain-kfold writes them: 24 training and 12 test
    rows of 96 f32 features, balanced labels, the classes a little apart."""
    rng = np.random.default_rng(seed)
    for k in range(n_splits):
        for split, n in (("train", 24), ("test", 12)):
            labels = rng.permutation(np.arange(n) % 2)
            feats = rng.standard_normal((n, 96)).astype(np.float32) + 0.25 * labels[:, None].astype(np.float32)
            np.save(root / f"{split}_contrast_ssl_features_split_{k}.npy", feats)
            np.save(root / f"{split}_contrast_ssl_labels_split_{k}.npy", labels)
    return str(root)


def test_evaluate_features_linear_matches_jax(tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, 2, seed=11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SkConvergenceWarning)
        want = jec.evaluate_features(feature_dir, n_splits=2, method="linear")
    want_out = capsys.readouterr().out
    got = tec.evaluate_features(feature_dir, n_splits=2, method="linear")
    assert capsys.readouterr().out == want_out
    assert got == want
    assert all(0.0 <= a <= 1.0 for a in got["per_fold"]["auroc"])


def test_cli_linear_prints_the_summary(tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, 2, seed=12)
    assert cli_main(["eval-classical", "--feature-dir", feature_dir, "--n-splits", "2", "--method", "linear"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    want = tec.evaluate_features(feature_dir, n_splits=2, method="linear")
    assert json.loads(last) == json.loads(json.dumps(want))
