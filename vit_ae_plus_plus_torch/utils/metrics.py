"""Evaluation metrics of the downstream classifiers (host-side numpy).

The port's copy of the JAX package's `utils/metrics.py`, which takes
`confusion_matrix` and `roc_auc_score` from scikit-learn. The GPU machine
has no scikit-learn, so this module carries numpy copies of the two, for the
inputs the metrics give them (held to scikit-learn in
tests/test_torch_port_eval_metrics.py):

- `confusion_matrix(y_true, y_pred, labels)`: rows indexed by `y_true`,
  columns by `y_pred`, pairs with a value outside `labels` not counted;
- `roc_auc_score(one_hot, scores)`: the macro average over the columns of a
  label-indicator matrix of each column's binary ROC AUC, computed as
  scikit-learn computes it (equal bit for bit); a column holding a single
  class raises `ValueError`.

Kept from the reference (used_metrics.py:12-41) through the JAX package: the
transposed confusion-matrix convention, `confusion_matrix(predictions,
target)`, so specificity = cm[0,0] / (cm[0,0] + cm[1,0]), and a
single-class evaluation set reads AUC 0.5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=1, keepdims=True)


def confusion_matrix(y_true, y_pred, labels: Sequence[int]) -> np.ndarray:
    """(len(labels), len(labels)) int64 counts of (y_true == labels[i],
    y_pred == labels[j])."""
    y_true, y_pred, labels = np.asarray(y_true), np.asarray(y_pred), np.asarray(labels)
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    for i, a in enumerate(labels):
        for j, b in enumerate(labels):
            cm[i, j] = np.count_nonzero((y_true == a) & (y_pred == b))
    return cm


def _binary_auc(y: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of one binary column, in scikit-learn's
    arithmetic (metrics/_ranking.py `roc_curve` with drop_intermediate,
    then `auc`): true and false positives at each distinct threshold of the
    descending scores, collinear points dropped, the trapezoids summed."""
    y = np.asarray(y) != 0
    if np.all(y) or not np.any(y):
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in that case.")
    order = np.argsort(score, kind="stable")[::-1]
    score, y = score[order], y[order].astype(np.float64)
    threshold_idxs = np.r_[np.nonzero(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps = fps[keep], tps[keep]
    fpr = np.r_[0.0, fps] / fps[-1]
    tpr = np.r_[0.0, tps] / tps[-1]
    return float(np.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0))


def roc_auc_score(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Macro-averaged ROC AUC of a label-indicator matrix (n, C) against
    scores (n, C)."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score, dtype=np.float64)
    return float(np.mean([_binary_auc(y_true[:, c], y_score[:, c]) for c in range(y_true.shape[1])]))


def find_vals(predictions: np.ndarray, target: np.ndarray) -> Tuple[float, float]:
    """Specificity / sensitivity with the reference's transposed-CM convention
    (used_metrics.py:30-41)."""
    pred_labels = np.argmax(predictions, axis=1)
    # labels=[0, 1] forces a 2x2 matrix even when a tiny eval set collapses to
    # one class (identical values otherwise)
    cm = confusion_matrix(pred_labels, target, labels=[0, 1])
    with np.errstate(invalid="ignore"):
        specificity = cm[0, 0] / (cm[0, 0] + cm[1, 0])
        sensitivity = cm[1, 1] / (cm[1, 1] + cm[0, 1])
    return float(specificity), float(sensitivity)


def roc_auc(predictions: np.ndarray, target: np.ndarray) -> Tuple[float, float, float]:
    """(auc, specificity, sensitivity) from raw logits (used_metrics.py:12-19)."""
    specificity, sensitivity = find_vals(predictions, target)
    probs = _softmax(np.asarray(predictions, dtype=np.float64))
    target = np.asarray(target).astype(int)
    one_hot = np.eye(2)[target]
    try:
        auc = float(roc_auc_score(one_hot, probs))
    except ValueError:  # single-class eval set (degenerate tiny splits)
        auc = 0.5
    return auc, specificity, sensitivity


def acc_pred(predictions: np.ndarray, target: np.ndarray) -> float:
    preds = np.argmax(predictions, axis=1)
    return float((preds == np.asarray(target)).sum() / len(target))
