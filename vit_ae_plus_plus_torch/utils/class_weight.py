"""scikit-learn 1.9.0's balanced class weights (sklearn/utils/class_weight.py),
for one output: what the SVM, the logistic regression and the random
forest of the classical evaluation weigh their classes and rows by."""

from __future__ import annotations

import numpy as np


def compute_class_weight_balanced(classes: np.ndarray, y: np.ndarray) -> np.ndarray:
    """`compute_class_weight("balanced", classes=classes, y=y)`: for each
    of `classes`, n / (k * its count in y), where k is the number of
    distinct labels in y (float64)."""
    y = np.asarray(y).ravel()
    classes = np.asarray(classes)
    labels, y_ind = np.unique(y, return_inverse=True)  # LabelEncoder().fit_transform(y)
    if set(labels) - set(classes):
        raise ValueError("classes should include all valid labels that can be in y")
    if not np.isin(classes, labels).all():
        raise ValueError("classes should have valid labels that are in y")
    counts = np.bincount(y_ind, weights=np.ones(y.shape[0], dtype=np.float64))
    recip_freq = np.sum(counts) / (labels.shape[0] * counts)
    return recip_freq[np.searchsorted(labels, classes)]


def compute_sample_weight_balanced(y: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """`compute_sample_weight("balanced", y, indices=indices)` for labels of
    one output: each row's class weight, balanced over the rows `indices`
    picks (a bootstrap, with repeats); a class the subsample misses weighs
    0 (float64)."""
    y_full = np.asarray(y).ravel()
    classes_full = np.unique(y_full)
    y_subsample = y_full[indices]
    classes_subsample = np.unique(y_subsample)
    weight = np.take(compute_class_weight_balanced(classes_subsample, y_subsample),
                     np.searchsorted(classes_subsample, classes_full), mode="clip")
    weight = weight[np.searchsorted(classes_full, y_full)]
    missing = set(classes_full) - set(classes_subsample)
    if missing:
        weight[np.isin(y_full, list(missing))] = 0.0
    return weight
