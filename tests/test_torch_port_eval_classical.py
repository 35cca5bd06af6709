"""The port's classical evaluation against scikit-learn and the JAX package,
on the CPU.

- The port's copy of scikit-learn's libsvm (utils/libsvm.py, built with
  g++ at first use) as `SVC` against `sklearn.svm.SVC(probability=True,
  random_state=42, class_weight="balanced")`, for each kernel and C of the
  search's grid, on an imbalanced 40 x 32 problem and a balanced 24 x 768
  one (the width of a ViT-B feature): `decision_function`, `predict` and
  `predict_proba` on held-out rows, the support and the dual coefficients,
  all equal bit for bit (both call scipy's `ddot`).
- `RandomizedSearchCV` against scikit-learn's with random_state 42: the
  candidates in order, every split's score, `mean_test_score`,
  `rank_test_score`, `best_params_` and `predict_proba` after the refit,
  equal; the parameter sampler on the rf and linear grids (a permutation's
  head) and `sample_without_replacement`'s two ported methods, equal, and
  the third (tracking selection, for ratios up to 0.01) refused.
- `evaluate_features` against the JAX package's on a seeded feature
  directory with 2 and 3 folds: the summary dicts equal, and the printed
  lines.
- The binary AUC that `evaluate_results` takes from utils/metrics.py,
  bitwise scikit-learn's; a single-class test fold raises `ValueError`.
- An unknown method raises `ValueError` before any file is read (`rf`
  and `linear` run: test_torch_port_forest*.py, test_torch_port_linear.py);
  the CLI prints the summary as its last line.
"""

import json
import warnings

import numpy as np
import pytest
import torch
from sklearn import svm as sk_svm
from sklearn.metrics import roc_auc_score as sk_roc_auc_score
from sklearn.model_selection import ParameterSampler as SkParameterSampler
from sklearn.model_selection import RandomizedSearchCV as SkRandomizedSearchCV
from sklearn.utils.random import sample_without_replacement as sk_sample_without_replacement

from vit_ae_plus_plus_tpu.pipelines import eval_classical as jec
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.cli import run as cli_run
from vit_ae_plus_plus_torch.pipelines import classical_models as cm
from vit_ae_plus_plus_torch.pipelines import eval_classical as tec
from vit_ae_plus_plus_torch.utils import libsvm
from vit_ae_plus_plus_torch.utils.metrics import roc_auc_score


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def quiet():
    # sklearn 1.9 deprecates SVC(probability=True) with a FutureWarning;
    # both searches warn that the 8-point grid is smaller than n_iter
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.simplefilter("ignore", UserWarning)
        yield


def _problem(name: str):
    """(X, y, X_test) in f32, as the feature dumps hold them."""
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


@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("C", [0.1, 1, 5, 10])
def test_svc_matches_sklearn_bitwise(problem, kernel, C):
    X, y, X_test = _problem(problem)
    want = sk_svm.SVC(C=C, kernel=kernel, probability=True, random_state=42, class_weight="balanced").fit(X, y)
    got = cm.SVC(C=C, kernel=kernel, probability=True, random_state=42).fit(X, y)
    for attr in ("support_", "dual_coef_", "intercept_", "class_weight_", "classes_"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert got._gamma == want._gamma
    for method in ("decision_function", "predict", "predict_proba"):
        g, w = getattr(got, method)(X_test), getattr(want, method)(X_test)
        assert g.dtype == w.dtype and np.array_equal(g, w), (method, g, w)


def test_libsvm_refuses_bad_parameters_and_unbuilt_compilers(monkeypatch, tmp_path):
    X, y, _ = _problem("imbalanced")
    with pytest.raises(ValueError, match="C <= 0"):
        libsvm.fit(X, y.astype(np.float64), C=0.0)
    with pytest.raises(ValueError, match="2-d"):
        libsvm.fit(X[0], y.astype(np.float64))
    # no g++ and no library built: the build raises and names the cause
    monkeypatch.setattr(libsvm, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        libsvm.build()


def test_parameter_sampling_matches_sklearn():
    for grid in cm.PARAM_GRIDS.values():
        want = list(SkParameterSampler(grid, n_iter=10, random_state=42))
        assert cm.sample_parameters(grid, 42) == want
    for n_pop, n in ((8, 8), (16, 10), (24, 10), (100, 60), (50, 49)):
        want = sk_sample_without_replacement(n_pop, n, random_state=np.random.RandomState(7))
        got = cm.sample_without_replacement(n_pop, n, np.random.RandomState(7))
        assert np.array_equal(got, want), (n_pop, n)
    with pytest.raises(NotImplementedError, match="tracking selection"):
        cm.sample_without_replacement(1000, 5, np.random.RandomState(7))


@pytest.mark.parametrize("problem", PROBLEMS)
def test_search_matches_sklearn(problem):
    X, y, X_test = _problem(problem)
    est = sk_svm.SVC(probability=True, random_state=42, class_weight="balanced")
    want = SkRandomizedSearchCV(est, cm.PARAM_GRIDS["svm"], refit=True, random_state=42).fit(X, y)
    got = cm.RandomizedSearchCV(cm._estimator("svm"), cm.PARAM_GRIDS["svm"], random_state=42).fit(X, y)
    assert got.cv_results_["params"] == list(want.cv_results_["params"])
    for key in ("mean_test_score", "std_test_score", "rank_test_score",
                *(f"split{k}_test_score" for k in range(5))):
        g, w = got.cv_results_[key], want.cv_results_[key]
        assert g.dtype == w.dtype and np.array_equal(g, w), (key, g, w)
    assert got.best_params_ == want.best_params_ and got.best_index_ == want.best_index_
    assert np.array_equal(got.predict_proba(X_test), want.predict_proba(X_test))
    probs = cm.execute_models(X, y, X_test, "svm")["svm"]
    assert np.array_equal(probs, want.predict_proba(X_test))


def test_search_scores_a_failed_fit_nan_and_raises_when_all_fail():
    X, y, _ = _problem("imbalanced")
    y = np.zeros_like(y)
    y[0] = 1  # one member: the split that tests it trains on one class
    with pytest.warns(UserWarning, match="fit failed"):
        got = cm.RandomizedSearchCV(cm._estimator("svm"), cm.PARAM_GRIDS["svm"], random_state=42).fit(X, y)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        est = sk_svm.SVC(probability=True, random_state=42, class_weight="balanced")
        want = SkRandomizedSearchCV(est, cm.PARAM_GRIDS["svm"], random_state=42).fit(X, y)
    for key in ("mean_test_score", "rank_test_score", *(f"split{k}_test_score" for k in range(5))):
        assert np.array_equal(got.cv_results_[key], want.cv_results_[key], equal_nan=True), key
    assert got.best_params_ == want.best_params_
    with pytest.raises(ValueError, match="All the 40 fits failed"):
        cm.RandomizedSearchCV(cm._estimator("svm"), cm.PARAM_GRIDS["svm"], random_state=42).fit(X, np.zeros_like(y))


def test_binary_auc_is_sklearns_bitwise():
    rng = np.random.default_rng(3)
    for i in range(200):
        n = int(rng.integers(4, 50))
        y = rng.integers(0, 2, n)
        y[:2] = [0, 1]
        s = rng.random(n)
        if i % 2:
            s = np.round(s, 1)  # ties
        assert roc_auc_score(y[:, None], s[:, None]) == sk_roc_auc_score(y, s)


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


@pytest.mark.parametrize("n_splits", [2, 3])
def test_evaluate_features_matches_jax(n_splits, tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, n_splits, seed=n_splits)
    want = jec.evaluate_features(feature_dir, n_splits=n_splits)
    want_out = capsys.readouterr().out
    got = tec.evaluate_features(feature_dir, n_splits=n_splits)
    assert capsys.readouterr().out == want_out
    assert got == want
    assert all(0.0 <= a <= 1.0 for a in got["per_fold"]["auroc"])


def test_evaluate_results_matches_jax_and_raises_on_one_class():
    rng = np.random.default_rng(5)
    for _ in range(20):
        labels = rng.permutation(np.arange(12) % 2)
        probs = rng.random(12)
        assert tec.evaluate_results(probs, labels) == jec.evaluate_results(probs, labels)
    # every prediction above the threshold: specificity 0, sensitivity 1
    labels = np.arange(12) % 2
    got, want = tec.evaluate_results(np.full(12, 0.9), labels), jec.evaluate_results(np.full(12, 0.9), labels)
    assert got == want and got[:2] == (0.0, 1.0)
    with pytest.raises(ValueError, match="Only one class"):
        tec.evaluate_results(np.linspace(0, 1, 12), np.ones(12, dtype=int))


def test_invalid_method_raises_before_reading(tmp_path):
    with pytest.raises(ValueError, match="invalid method"):
        tec.evaluate_features(str(tmp_path / "missing"), method="knn")
    # a known method on a missing directory: the CLI names it and exits 2
    assert cli_run(["eval-classical", "--feature-dir", str(tmp_path / "missing"), "--method", "rf"]) == 2


def test_cli_prints_the_summary(tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, 2, seed=9)
    assert cli_main(["eval-classical", "--feature-dir", feature_dir, "--n-splits", "2"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(tec.evaluate_features(feature_dir, n_splits=2)))
