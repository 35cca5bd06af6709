"""The port's evaluation metrics and unstratified split against the JAX
package's and scikit-learn's, on the CPU.

`utils/metrics.py` of the port carries numpy copies of scikit-learn's
`confusion_matrix` and `roc_auc_score` (the GPU machine has no
scikit-learn); the JAX package's module calls scikit-learn. The same logits
go through both: random logits, logits with tied probabilities (whole rows
repeated, and a column of one value), a single-class set, a set whose
predictions collapse to one class (NaN specificity or sensitivity).
Tolerance 1e-12: the same numbers.

A single-class set reads AUC 0.5 by the reference's rule, which the JAX
package implements by catching scikit-learn's `ValueError`. scikit-learn
1.9 no longer raises there: it warns and returns NaN, so the JAX package
reads NaN on such a set with that version. The port keeps the rule (its
`roc_auc_score` raises, `roc_auc` reads 0.5); the single-class case holds
specificity, sensitivity and accuracy to the JAX package and the AUC to
0.5.
`data/splits.py`'s `train_test_split` is held to scikit-learn's at several
sizes, equal.
"""

import numpy as np
import pytest
from sklearn.metrics import confusion_matrix as sk_confusion_matrix
from sklearn.metrics import roc_auc_score as sk_roc_auc_score
from sklearn.model_selection import train_test_split as sk_train_test_split

from vit_ae_plus_plus_tpu.utils import metrics as jm
from vit_ae_plus_plus_torch.data.splits import train_test_split
from vit_ae_plus_plus_torch.utils import metrics as tm

TOL = 1e-12


def _case(name: str, seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 40))
    logits = rng.standard_normal((n, 2)).astype(np.float32)
    target = rng.integers(0, 2, n)
    target[:2] = [0, 1]
    if name == "ties":  # repeated rows: equal probabilities across samples
        logits[n // 2:] = logits[0]
    elif name == "column_ties":  # one logit column constant, the other coarse
        logits[:, 0] = 0.5
        logits[:, 1] = np.round(logits[:, 1])
    elif name == "single_class":
        target[:] = 1
    elif name == "collapsed":  # every prediction is class 1
        logits[:, 1] = logits[:, 0] + 1.0
    elif name == "big":
        logits *= 30.0
    return logits, target


CASES = [(name, seed) for name in ("random", "ties", "column_ties", "single_class", "collapsed", "big")
         for seed in (0, 1)]


def _close(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want)), (got, want)
    ok = ~np.isnan(want)
    assert np.all(np.abs(got[ok] - want[ok]) <= TOL), (got, want)


@pytest.mark.parametrize("name,seed", CASES)
def test_roc_auc_find_vals_acc_pred_match_jax(name, seed):
    logits, target = _case(name, seed)
    got, want = tm.roc_auc(logits, target), jm.roc_auc(logits, target)
    if name == "single_class":
        assert got[0] == 0.5
        got, want = got[1:], want[1:]
    _close(got, want)
    _close(tm.find_vals(logits, target), jm.find_vals(logits, target))
    _close(tm.acc_pred(logits, target), jm.acc_pred(logits, target))


@pytest.mark.parametrize("name,seed", CASES)
def test_numpy_copies_match_scikit_learn(name, seed):
    logits, target = _case(name, seed)
    pred = np.argmax(logits, axis=1)
    np.testing.assert_array_equal(tm.confusion_matrix(pred, target, labels=[0, 1]),
                                  sk_confusion_matrix(pred, target, labels=[0, 1]))
    one_hot = np.eye(2)[target]
    probs = tm._softmax(logits.astype(np.float64))
    if name == "single_class":  # undefined: scikit-learn 1.9 warns and reads NaN
        with pytest.warns(UserWarning):
            assert np.isnan(sk_roc_auc_score(one_hot, probs))
        with pytest.raises(ValueError):
            tm.roc_auc_score(one_hot, probs)
    else:
        assert abs(tm.roc_auc_score(one_hot, probs) - sk_roc_auc_score(one_hot, probs)) <= TOL


def test_confusion_matrix_ignores_values_outside_labels():
    y_true, y_pred = np.array([0, 1, 2, 1, 0, 2]), np.array([1, 1, 0, 2, 0, 0])
    np.testing.assert_array_equal(tm.confusion_matrix(y_true, y_pred, labels=[0, 1]),
                                  sk_confusion_matrix(y_true, y_pred, labels=[0, 1]))


@pytest.mark.parametrize("n", [2, 5, 9, 10, 15, 19, 24, 31, 100])
def test_train_test_split_matches_scikit_learn(n):
    ids = np.arange(100, 100 + n) * 3
    want = sk_train_test_split(ids, test_size=0.20, random_state=42, stratify=None)
    got = train_test_split(ids, test_size=0.20, random_state=42)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_train_test_split_refusals():
    with pytest.raises(ValueError):
        train_test_split(np.arange(4), test_size=1.5, random_state=0)
    with pytest.raises(ValueError):  # one sample: nothing left to train on
        train_test_split(np.arange(1), test_size=0.2, random_state=0)
