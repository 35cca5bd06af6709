"""The port's random forest (`eval-classical --method rf`) against
scikit-learn 1.9.0, on the CPU: the trees and the forests.

- `RandomForestClassifier` (pipelines/forest.py, on the port's copy of
  scikit-learn's tree builder in native/tree/) against
  `sklearn.ensemble.RandomForestClassifier(random_state=42, ...)` at all 16
  points of the rf grid (n_estimators x criterion x class_weight), on the
  imbalanced 40 x 32 and the balanced 24 x 768 problems of
  test_torch_port_eval_classical.py, in float32 (as the feature dumps hold
  them) and float64 (cast to float32 by both): every tree's arrays
  (children, feature, threshold, impurity, row counts and weights, the
  side missing values take, the class fractions), `predict_proba`,
  `predict` and `score` on held-out rows, all equal bit for bit; the same
  with class_weight None and with three classes.
- `DecisionTreeClassifier(max_features="sqrt")` with bootstrap-count
  weights at several seeds and both criteria, on a problem with duplicate
  rows and a constant feature, on a stand-in of 5d's near-constant bf16
  features (where ties are common) and on the imbalanced problem: the
  tree's arrays, `apply` and `predict_proba`, equal.
- The splitter's sort against scikit-learn's `simultaneous_sort` (both
  partitions, ties, sorted and adversarial inputs), the balanced class and
  sample weights (with `indices=`) against scikit-learn's, equal.
- The tree library refuses to build without g++; NaN and infinite rows
  are refused.
- chip_smoke.py's RF_REFERENCE (the card's gate) equals scikit-learn's
  live output, and its control (random_state=43) misses it.

The search over the rf grid, `evaluate_features(method="rf")` and the CLI:
test_torch_port_forest_search.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
from sklearn.ensemble import RandomForestClassifier as SkRandomForestClassifier
from sklearn.tree import DecisionTreeClassifier as SkDecisionTreeClassifier
from sklearn.utils._sorting import _py_simultaneous_sort
from sklearn.utils.class_weight import compute_class_weight as sk_compute_class_weight
from sklearn.utils.class_weight import compute_sample_weight as sk_compute_sample_weight

from vit_ae_plus_plus_torch.pipelines import classical_models as cm
from vit_ae_plus_plus_torch.pipelines.forest import DecisionTreeClassifier, RandomForestClassifier
from vit_ae_plus_plus_torch.utils import tree
from vit_ae_plus_plus_torch.utils.class_weight import compute_class_weight_balanced, compute_sample_weight_balanced

ARRAYS = ("children_left", "children_right", "feature", "threshold", "impurity", "n_node_samples",
          "weighted_n_node_samples", "missing_go_to_left", "value")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _problem(name: str, dtype=np.float32):
    """(X, y, X_test) as test_torch_port_eval_classical.py makes them in
    float32; in float64 the same draws are not rounded to float32."""
    if name == "imbalanced":
        rng = np.random.default_rng(0)
        n, d, n_pos = 40, 32, 11
    else:
        rng = np.random.default_rng(1)
        n, d, n_pos = 24, 768, 12
    y = np.zeros(n, dtype=np.int64)
    y[rng.permutation(n)[:n_pos]] = 1
    X = rng.standard_normal((n, d)).astype(dtype) + 0.3 * y[:, None].astype(dtype)
    X_test = rng.standard_normal((12, d)).astype(dtype) + 0.3 * (np.arange(12) % 2)[:, None]
    return X.astype(dtype), y, X_test.astype(dtype)


def _assert_trees_equal(got, want, where):
    for name in ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (where, name, g, w)
    assert got.node_count == want.node_count and got.max_depth == want.max_depth, where


def _assert_forests_equal(got, want, X_test, y_test):
    assert len(got.estimators_) == len(want.estimators_)
    for i, (g, w) in enumerate(zip(got.estimators_, want.estimators_)):
        _assert_trees_equal(g.tree_, w.tree_, f"tree {i}")
    assert np.array_equal(got.classes_, want.classes_)
    for method in ("predict_proba", "predict"):
        g, w = getattr(got, method)(X_test), getattr(want, method)(X_test)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (method, g, w)
    assert got.score(X_test, y_test) == want.score(X_test, y_test)


PROBLEMS = ("imbalanced", "balanced")
POINTS = cm.parameter_grid(cm.PARAM_GRIDS["rf"])


def test_the_grid_has_16_points():
    assert len(POINTS) == 16
    assert {(p["criterion"], p["class_weight"]) for p in POINTS} == {
        (c, w) for c in ("gini", "entropy") for w in ("balanced", "balanced_subsample")}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("point", range(16))
def test_forest_matches_sklearn_bitwise(point, problem, dtype):
    params = POINTS[point]
    X, y, X_test = _problem(problem, dtype)
    want = SkRandomForestClassifier(random_state=42, **params).fit(X, y)
    got = RandomForestClassifier(random_state=42, **params).fit(X, y)
    _assert_forests_equal(got, want, X_test, np.arange(12) % 2)


@pytest.mark.parametrize("criterion", ["gini", "entropy"])
def test_forest_without_class_weight_and_with_three_classes(criterion):
    X, y, X_test = _problem("imbalanced")
    for labels in (y, np.arange(y.shape[0]) % 3 + 5):
        want = SkRandomForestClassifier(n_estimators=30, criterion=criterion, random_state=7).fit(X, labels)
        got = RandomForestClassifier(n_estimators=30, criterion=criterion, random_state=7).fit(X, labels)
        _assert_forests_equal(got, want, X_test, labels[:12])
        for class_weight in ("balanced", "balanced_subsample"):
            want = SkRandomForestClassifier(n_estimators=30, criterion=criterion, class_weight=class_weight,
                                            random_state=3).fit(X, labels)
            got = RandomForestClassifier(n_estimators=30, criterion=criterion, class_weight=class_weight,
                                         random_state=3).fit(X, labels)
            _assert_forests_equal(got, want, X_test, labels[:12])


def _tree_problem(name: str):
    """(X, y) for single trees: duplicate rows and a constant feature; a
    stand-in of 5d's near-constant bf16 features (chip_smoke's RF problem);
    or the imbalanced problem."""
    if name == "duplicates":
        rng = np.random.default_rng(5)
        X = rng.standard_normal((30, 10)).astype(np.float32)
        X[10:20] = X[:10]
        X[:, 3] = 1.5
        return X, rng.integers(0, 2, 30)
    if name == "near_constant":
        X, y, _ = _load_chip_smoke().rf_reference_problem()
        return X, y
    X, y, _ = _problem("imbalanced")
    return X, y


@pytest.mark.parametrize("criterion", ["gini", "entropy"])
@pytest.mark.parametrize("problem", ["duplicates", "near_constant", "imbalanced"])
def test_decision_tree_matches_sklearn_with_bootstrap_counts(problem, criterion):
    X, y = _tree_problem(problem)
    n = X.shape[0]
    for seed in range(8):
        counts = np.bincount(np.random.RandomState(seed).randint(0, n, n), minlength=n)
        want = SkDecisionTreeClassifier(criterion=criterion, max_features="sqrt", random_state=seed).fit(
            X, y, sample_weight=counts)
        got = DecisionTreeClassifier(criterion=criterion, max_features="sqrt", random_state=seed).fit(
            X, y, sample_weight=counts)
        _assert_trees_equal(got.tree_, want.tree_, (problem, seed))
        assert got.max_features_ == want.max_features_
        assert np.array_equal(got.apply(X), want.apply(X))
        assert np.array_equal(got.predict_proba(X), want.predict_proba(X))
    # no weights, every feature drawn
    want = SkDecisionTreeClassifier(criterion=criterion, random_state=1).fit(X, y)
    got = DecisionTreeClassifier(criterion=criterion, random_state=1).fit(X, y)
    _assert_trees_equal(got.tree_, want.tree_, (problem, "unweighted"))


def test_the_splitters_sort_is_sklearns():
    rng = np.random.default_rng(0)

    def median3_killer(n):  # Musser's median-of-3 killer sequence
        k, a = n // 2, np.empty(n)
        for i in range(1, k + 1):
            if i % 2 == 1:
                a[i - 1], a[i] = i, k + i
            a[k + i - 1] = 2 * i
        return a

    cases = []
    for n in (0, 1, 2, 15, 16, 17, 100, 1000, 4096):
        cases += [rng.standard_normal(n), np.round(rng.standard_normal(n), 1), np.sort(rng.standard_normal(n)),
                  -np.sort(rng.standard_normal(n)), np.zeros(n), np.abs(np.arange(n) - n // 2)]
        if n >= 2 and n % 2 == 0:
            cases.append(median3_killer(n))
    for values in cases:
        for three_way in (True, False):
            want_v, want_i = values.astype(np.float32), np.arange(len(values), dtype=np.intp)
            got_v, got_i = want_v.copy(), want_i.copy()
            if len(values):
                _py_simultaneous_sort(want_v, want_i, len(values), use_three_way_partition=three_way)
            tree.simultaneous_sort(got_v, got_i, three_way)
            assert np.array_equal(got_v, want_v) and np.array_equal(got_i, want_i), (len(values), three_way)


def test_balanced_weights_match_sklearn():
    rng = np.random.default_rng(2)
    for _ in range(50):
        n = int(rng.integers(2, 60))
        y = rng.choice(np.array([3, 7, 8]), n, p=rng.dirichlet(np.ones(3)))
        classes = np.unique(y)
        got, want = compute_class_weight_balanced(classes, y), sk_compute_class_weight("balanced", classes=classes, y=y)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for _ in range(4):  # a bootstrap, which may miss a class
            indices = rng.integers(0, n, n)
            got = compute_sample_weight_balanced(y, indices=indices)
            want = sk_compute_sample_weight("balanced", y, indices=indices)
            assert got.dtype == want.dtype and np.array_equal(got, want), (y, indices)
    with pytest.raises(ValueError, match="classes should"):
        compute_class_weight_balanced(np.array([0, 1]), np.array([0, 1, 2]))


def test_tree_library_refuses_a_missing_compiler_and_bad_rows(monkeypatch, tmp_path):
    X, y, _ = _problem("imbalanced")
    bad = X.copy()
    bad[3, 4] = np.nan
    with pytest.raises(NotImplementedError, match="missing values"):
        RandomForestClassifier(n_estimators=2).fit(bad, y)
    bad[3, 4] = np.inf
    with pytest.raises(ValueError, match="infinity"):
        RandomForestClassifier(n_estimators=2).fit(bad, y)
    with pytest.raises(NotImplementedError, match="class_weight"):
        RandomForestClassifier(n_estimators=2, class_weight={0: 1.0, 1: 2.0}).fit(X, y)
    with pytest.raises(ValueError, match="invalid parameter"):
        RandomForestClassifier().set_params(max_depth=3)
    # no g++ and no library built: the build raises and names the cause
    monkeypatch.setattr(tree, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tree.build()


def test_rf_reference_is_sklearns():
    """chip_smoke.py's RF_REFERENCE against scikit-learn 1.9.0's live fits
    on its stand-in of 5d's features (and the port's), and the control at
    random_state=43 missing it."""
    chip_smoke = _load_chip_smoke()
    X, y, X_test = chip_smoke.rf_reference_problem()
    # bf16 values: ties are common
    assert np.mean([len(np.unique(X[:, j])) for j in range(X.shape[1])]) < 0.8 * X.shape[0]
    assert len(chip_smoke.RF_REFERENCE) >= 2
    covered = {(r["params"]["criterion"], r["params"]["class_weight"]) for r in chip_smoke.RF_REFERENCE}
    assert {c for c, _ in covered} == {"gini", "entropy"}
    assert {w for _, w in covered} == {"balanced", "balanced_subsample"}
    for ref in chip_smoke.RF_REFERENCE:
        for seed in (42, 43):
            want = SkRandomForestClassifier(random_state=seed, **ref["params"]).fit(X, y)
            got = RandomForestClassifier(random_state=seed, **ref["params"]).fit(X, y)
            _assert_forests_equal(got, want, X_test, np.arange(24) % 2)
            digest = chip_smoke.forest_digest(e.tree_ for e in want.estimators_)
            assert chip_smoke.forest_digest(e.tree_ for e in got.estimators_) == digest
            proba1 = want.predict_proba(X_test)[:, 1]
            if seed == 42:
                assert digest == ref["trees_sha256"] and np.array_equal(proba1, np.asarray(ref["proba1"]))
            else:
                assert digest != ref["trees_sha256"] and not np.array_equal(proba1, np.asarray(ref["proba1"]))
