"""Classical evaluation of extracted SSL features (per-fold SVM + metrics).

The port's counterpart of the JAX package's pipelines/eval_classical.py
(reference feature_evaluation_script/evaluation_k_fold_brats.py:13-81): per
fold, load `{train,test}_contrast_ssl_{features,labels}_split_{idx}.npy`
(as `pretrain-kfold` writes them), fit the SVM through the search
(classical_models.py), take P(class 1), the AUROC on the raw
probabilities, then threshold at 0.65 for specificity and sensitivity with
the transposed confusion-matrix convention; mean and std over folds. Host
work only, as in the JAX package. The feature normalisation helpers exist
but are unused, as in the reference (:30-33).

The metrics are the port's copies of scikit-learn's (utils/metrics.py).
`confusion_matrix(hard, test_labels)` is given the union of both label
sets, as scikit-learn takes it. A test fold holding a single class raises
`ValueError`, as the reference's scikit-learn did; scikit-learn 1.9, which
the JAX package runs on, reads NaN there instead (ROADMAP Queue 3).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from vit_ae_plus_plus_torch.pipelines.classical_models import check_methods, execute_models
from vit_ae_plus_plus_torch.utils.metrics import confusion_matrix, roc_auc_score

THRESHOLD = 0.65  # evaluation_k_fold_brats.py:38-39


def min_max_normalize(vector: np.ndarray, factor: float = 1.0) -> np.ndarray:
    return factor * (vector - np.min(vector)) / (np.max(vector) - np.min(vector))


def z_score_normalize(vector: np.ndarray) -> np.ndarray:
    vector = vector - np.mean(vector)
    return vector / (2 * np.std(vector) + 0.001)


def evaluate_results(pred_probs: np.ndarray, test_labels: np.ndarray) -> Tuple[float, float, float]:
    """(specificity, sensitivity, auroc) at the 0.65 operating point
    (evaluation_k_fold_brats.py:36-46)."""
    pred_probs = np.array(pred_probs, dtype=np.float64)
    test_labels = np.asarray(test_labels)
    # scikit-learn's binary AUC: the larger of the two labels is positive
    positive = test_labels == np.unique(test_labels)[-1]
    auroc = roc_auc_score(positive[:, None], pred_probs[:, None])
    hard = (pred_probs >= THRESHOLD).astype(int)
    cm = confusion_matrix(hard, test_labels, labels=np.union1d(hard, test_labels))
    specificity = cm[0, 0] / (cm[0, 0] + cm[1, 0])
    sensitivity = cm[1, 1] / (cm[1, 1] + cm[0, 1])
    return float(specificity), float(sensitivity), float(auroc)


def work_on_fold(feature_dir: str, idx: int, method: str = "svm") -> Tuple[float, float, float]:
    train_features = np.load(os.path.join(feature_dir, f"train_contrast_ssl_features_split_{idx}.npy"))
    test_features = np.load(os.path.join(feature_dir, f"test_contrast_ssl_features_split_{idx}.npy"))
    train_labels = np.load(os.path.join(feature_dir, f"train_contrast_ssl_labels_split_{idx}.npy"))
    test_labels = np.load(os.path.join(feature_dir, f"test_contrast_ssl_labels_split_{idx}.npy"))
    preds = execute_models(train_features, train_labels, test_features, method)[method]
    return evaluate_results(preds[:, 1], test_labels)


def evaluate_features(feature_dir: str, n_splits: int = 5, method: str = "svm") -> Dict:
    """Mean +- std of AUROC / specificity / sensitivity over folds."""
    check_methods(method)
    spec, sens, auroc = [], [], []
    for idx in range(n_splits):
        s, n, a = work_on_fold(feature_dir, idx, method)
        spec.append(s)
        sens.append(n)
        auroc.append(a)
    summary = {
        "specificity_mean": float(np.mean(spec)),
        "sensitivity_mean": float(np.mean(sens)),
        "auroc_mean": float(np.mean(auroc)),
        "auroc_std": float(np.std(auroc)),
        "per_fold": {"specificity": spec, "sensitivity": sens, "auroc": auroc},
    }
    print(
        f"Average specificity {summary['specificity_mean']} and sensitivity "
        f"{summary['sensitivity_mean']} roc: {summary['auroc_mean']}"
    )
    print(f"roc std: {summary['auroc_std']}")
    return summary
