"""The port's `eval-classical --method rf` against scikit-learn 1.9.0 and the
JAX package, on the CPU: the search and the command.

- `RandomizedSearchCV` over the rf grid with the port's
  `RandomForestClassifier(random_state=42)` against scikit-learn's with
  `sklearn.ensemble.RandomForestClassifier(random_state=42)`, on the
  imbalanced 40 x 32 and the balanced 24 x 768 problems of
  test_torch_port_eval_classical.py: the candidates in order, every
  split's score, `mean_test_score`, `std_test_score`, `rank_test_score`,
  `best_params_`, and `predict_proba` after the refit (and through
  `execute_models`), equal.
- `evaluate_features(method="rf")` against the JAX package's on a seeded
  feature directory of 2 folds: the summary dicts and the printed lines.
- The CLI prints the summary as its last line.

scikit-learn's search grows about 6,000 trees in Python (some 15 s here);
each runs once, and the port's about ten times faster.
The trees and forests themselves: test_torch_port_forest.py.
"""

import json
import warnings

import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier as SkRandomForestClassifier
from sklearn.model_selection import RandomizedSearchCV as SkRandomizedSearchCV

from vit_ae_plus_plus_tpu.pipelines import eval_classical as jec
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.pipelines import classical_models as cm
from vit_ae_plus_plus_torch.pipelines import eval_classical as tec


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


@pytest.mark.parametrize("problem", ["imbalanced", "balanced"])
def test_rf_search_matches_sklearn(problem):
    X, y, X_test = _problem(problem)
    want = SkRandomizedSearchCV(SkRandomForestClassifier(random_state=42), cm.PARAM_GRIDS["rf"], refit=True,
                                random_state=42).fit(X, y)
    got = cm.RandomizedSearchCV(cm._estimator("rf"), cm.PARAM_GRIDS["rf"], random_state=42).fit(X, y)
    assert got.cv_results_["params"] == list(want.cv_results_["params"])
    for key in ("mean_test_score", "std_test_score", "rank_test_score",
                *(f"split{k}_test_score" for k in range(5))):
        g, w = got.cv_results_[key], want.cv_results_[key]
        assert g.dtype == w.dtype and np.array_equal(g, w), (key, g, w)
    assert got.best_params_ == want.best_params_ and got.best_index_ == want.best_index_
    assert got.best_score_ == want.best_score_
    want_proba = want.predict_proba(X_test)
    assert np.array_equal(got.predict_proba(X_test), want_proba)
    assert np.array_equal(cm.execute_models(X, y, X_test, "rf")["rf"], want_proba)


def test_evaluate_features_rf_matches_jax(tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, 2, seed=13)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = jec.evaluate_features(feature_dir, n_splits=2, method="rf")
    want_out = capsys.readouterr().out
    got = tec.evaluate_features(feature_dir, n_splits=2, method="rf")
    assert capsys.readouterr().out == want_out
    assert got == want
    assert all(0.0 <= a <= 1.0 for a in got["per_fold"]["auroc"])


def test_cli_rf_prints_the_summary(tmp_path, capsys):
    feature_dir = _feature_dir(tmp_path, 2, seed=14)
    assert cli_main(["eval-classical", "--feature-dir", feature_dir, "--n-splits", "2", "--method", "rf"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    want = tec.evaluate_features(feature_dir, n_splits=2, method="rf")
    assert json.loads(last) == json.loads(json.dumps(want))
