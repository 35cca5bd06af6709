"""One-time dataset split bootstrap (the `prepare-data` CLI step).

The port's copy of the JAX package's `data/splits.py`: the same files with
the same contents. The JAX package draws its splits with scikit-learn's
`train_test_split(stratify=...)` and `StratifiedKFold`; this module carries
numpy copies of those two algorithms (`stratified_train_test_split`,
`stratified_kfold`) with the same random streams, so it runs where
scikit-learn is not installed and writes the same indices.

Parity targets:
- BraTS: reference bootstrap/brats/brats_split.py:23-88 —
  stratified 90/10 train/test then 90/10 train/val (random_state=42), saving
  index arrays plus materialised x/y_{train,val,test,whole}_ssl.npy.
- EGD: reference bootstrap/egd/egd_split.py:15-103 —
  radiologist CSV -> label -1 = SSL pool, else labelled pool; scans with
  missing modality files skipped; pickles per target column, plus the
  `correct_who_1p19q…` refinement removing IDH-SSL leakage (:79-90).

Deltas: paths are arguments (no hard-coded /mnt/...), the interactive
overwrite prompt is an `overwrite` flag, and k-fold index persistence
(reference k_fold_…_brats.py:113-125) lives here too.
"""

from __future__ import annotations

import math
import os
import pickle
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vit_ae_plus_plus_torch.data.egd import MODALITIES


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """Per-class draws closest to `n_draws * share`, ties broken by `rng`
    (scikit-learn's `utils.extmath._approximate_mode`)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_train_test_split(
    array: np.ndarray, labels: np.ndarray, train_size: float, random_state: int
) -> Tuple[np.ndarray, np.ndarray]:
    """`(array[train], array[test])`, stratified by `labels`: scikit-learn's
    `train_test_split(array, train_size=train_size, stratify=labels,
    random_state=random_state)` for a float `train_size` in (0, 1), drawn
    from the same `RandomState` stream (its `StratifiedShuffleSplit`)."""
    array, labels = np.asarray(array), np.asarray(labels)
    n = len(array)
    if not 0 < train_size < 1:
        raise ValueError(f"train_size={train_size} should be a float in the (0, 1) range")
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0 or n_test == 0:
        raise ValueError(f"train_size={train_size} of {n} samples leaves an empty split")
    classes, y_indices, class_counts = np.unique(labels, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(f"train ({n_train}) and test ({n_test}) sizes must each reach "
                         f"the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return array[rng.permutation(train)], array[rng.permutation(test)]


def stratified_kfold(labels: np.ndarray, n_splits: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """`(train_ids, test_ids)` per fold: scikit-learn's
    `StratifiedKFold(n_splits, shuffle=False).split(X, labels)`."""
    y = np.asarray(labels)
    if n_splits > len(y):
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater "
                         f"than the number of samples: n_samples={len(y)}.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    # classes numbered in the order they first appear
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    if np.all(n_splits > y_counts):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of "
                         "members in each class.")
    if n_splits > np.min(y_counts):
        warnings.warn(f"The least populated class in y has only {np.min(y_counts)} members, "
                      f"which is less than n_splits={n_splits}.", UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes) for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        test_folds[y_encoded == k] = np.arange(n_splits).repeat(allocation[:, k])
    ids = np.arange(len(y))
    return [(ids[test_folds != i], ids[test_folds == i]) for i in range(n_splits)]


def sanity_check_disjoint(*splits: Sequence[int]) -> bool:
    sets = [set(np.asarray(s).tolist()) for s in splits]
    for i in range(len(sets)):
        for j in range(i + 1, len(sets)):
            if sets[i] & sets[j]:
                return False
    return True


def split_brats_data(
    volumes_path: str,
    labels_path: str,
    out_dir: str,
    overwrite: bool = False,
) -> Dict[str, np.ndarray]:
    """Create BraTS SSL splits; returns the index arrays."""
    os.makedirs(out_dir, exist_ok=True)
    marker = os.path.join(out_dir, "x_train_ssl.npy")
    if os.path.exists(marker) and not overwrite:
        raise FileExistsError(f"{marker} exists; pass overwrite=True to recreate")

    data = np.load(volumes_path, mmap_mode="r")
    labels = np.load(labels_path)
    indices = np.arange(data.shape[0])
    train_idx, test_idx = stratified_train_test_split(
        indices, labels, train_size=0.9, random_state=42
    )
    train_idx, val_idx = stratified_train_test_split(
        train_idx, labels[train_idx], train_size=0.9, random_state=42
    )
    assert sanity_check_disjoint(train_idx, val_idx, test_idx)

    split_indices = {"train": train_idx, "val": val_idx, "test": test_idx, "whole": indices}
    for name, idx in split_indices.items():
        if name != "whole":
            np.save(os.path.join(out_dir, f"{name}_indices.npy"), idx)
        np.save(os.path.join(out_dir, f"x_{name}_ssl.npy"), np.asarray(data[np.sort(idx)] if name != "whole" else data))
        np.save(os.path.join(out_dir, f"y_{name}_ssl.npy"), labels[np.sort(idx)] if name != "whole" else labels)
    return split_indices


def ingest_nifti_volumes(
    nifti_dir: str,
    labels_csv: str,
    out_dir: str,
    pattern: str = "*.nii*",
    overwrite: bool = False,
) -> Tuple[str, str]:
    """Stack a directory of single-channel NIfTI scans into the monolithic
    `(N, S, S, S, 1)` volume + label arrays `split_brats_data` consumes.

    Raw BraTS distributions ship `.nii.gz` scans; the reference assumes an
    out-of-repo preprocessing step already produced the npy monolith
    (dataset/brats_dataset/brats.py:17 loads x_{mode}_ssl.npy). This closes
    that gap with the built-in NIfTI reader (utils/nifti.py — no nibabel).

    `labels_csv`: two columns `name,label`; `name` matches the file stem
    (`.nii`/`.nii.gz` stripped). Returns (volumes_path, labels_path).
    """
    import csv
    import glob

    from vit_ae_plus_plus_torch.utils.nifti import read_nifti

    # honour the overwrite contract BEFORE any scan reading: both this
    # function's outputs and split_brats_data's marker protect reruns
    for marker in ("volumes_all.npy", "x_train_ssl.npy"):
        p = os.path.join(out_dir, marker)
        if os.path.exists(p) and not overwrite:
            raise FileExistsError(f"{p} exists; pass overwrite=True to recreate")

    paths = sorted(glob.glob(os.path.join(nifti_dir, pattern)))
    if not paths:
        raise FileNotFoundError(f"no files matching {pattern} under {nifti_dir}")

    def stem(p: str) -> str:
        base = os.path.basename(p)
        for suf in (".nii.gz", ".nii"):
            if base.endswith(suf):
                return base[: -len(suf)]
        return base

    with open(labels_csv, newline="") as f:
        rows = [r for r in csv.reader(f) if r]

    def _label(row, lineno):
        if len(row) < 2:
            raise ValueError(
                f"{labels_csv}:{lineno}: expected name,label — got {row!r}"
            )
        try:
            return int(float(row[1]))  # '1' and '1.0' both accepted
        except ValueError:
            return None

    first_line = 1
    if rows and _label(rows[0], 1) is None:
        rows = rows[1:]  # header row
        first_line = 2
    label_by_name = {}
    for i, row in enumerate(rows, start=first_line):
        lab = _label(row, i)
        if lab is None:
            raise ValueError(
                f"{labels_csv}:{i}: label {row[1]!r} is not numeric"
            )
        label_by_name[row[0].strip()] = lab

    for p in paths:
        if stem(p) not in label_by_name:
            raise KeyError(f"{stem(p)} (from {p}) has no row in {labels_csv}")

    os.makedirs(out_dir, exist_ok=True)
    volumes_path = os.path.join(out_dir, "volumes_all.npy")
    labels_path = os.path.join(out_dir, "labels_all.npy")
    # stream scans straight into an on-disk npy memmap: a real BraTS corpus
    # is tens of GB — holding every decoded scan in RAM plus an np.stack
    # copy would OOM a typical host
    store = None
    shape = None
    labels = []
    for i, p in enumerate(paths):
        v = read_nifti(p)
        if v.ndim != 3:
            raise ValueError(f"{p}: expected a 3-D scan, got {v.ndim}-D")
        if shape is None:
            shape = v.shape
            store = np.lib.format.open_memmap(
                volumes_path, mode="w+", dtype=np.float32,
                shape=(len(paths), *shape, 1),  # channel-last (brats.py:17)
            )
        elif v.shape != shape:
            raise ValueError(f"{p}: shape {v.shape} != first scan's {shape}")
        store[i, ..., 0] = v
        labels.append(label_by_name[stem(p)])
    store.flush()
    del store
    np.save(labels_path, np.asarray(labels, np.int64))
    print(f"ingested {len(paths)} NIfTI scans of shape {shape} -> {volumes_path}")
    return volumes_path, labels_path


def convert_egd_nifti_scans(nifti_root: str, out_root: str) -> int:
    """Convert per-scan NIfTI modality files into the npy layout the EGD
    dataset reads (base_path/<scan>/{flair,t1ce,t1,t2}.npy — data/egd.py:88).

    Expects nifti_root/<scan>/<modality>.nii[.gz]; scans missing any of the
    4 modalities are skipped with a message (mirroring the bootstrap's
    missing-file tolerance, egd_split.py:26-27). Returns #scans converted."""
    from vit_ae_plus_plus_torch.utils.nifti import read_nifti

    modalities = MODALITIES  # the npy layout contract lives in data/egd.py
    converted = 0
    for scan in sorted(os.listdir(nifti_root)):
        scan_dir = os.path.join(nifti_root, scan)
        if not os.path.isdir(scan_dir):
            continue
        paths = {}
        for m in modalities:
            for suf in (".nii.gz", ".nii"):
                p = os.path.join(scan_dir, m + suf)
                if os.path.exists(p):
                    paths[m] = p
                    break
        if len(paths) != len(modalities):
            missing = sorted(set(modalities) - set(paths))
            print(f"skipping {scan}: missing modalities {missing}")
            continue
        out_dir = os.path.join(out_root, scan)
        os.makedirs(out_dir, exist_ok=True)
        for m, p in paths.items():
            vol = read_nifti(p)
            if vol.ndim != 3:
                raise ValueError(f"{p}: expected a 3-D scan, got {vol.ndim}-D")
            np.save(os.path.join(out_dir, f"{m}.npy"), vol)
        converted += 1
    if converted == 0:
        raise FileNotFoundError(f"no complete 4-modality scans under {nifti_root}")
    print(f"converted {converted} EGD scans -> {out_root}")
    return converted


def prepare_egd_splits(
    csv_path: str,
    scans_root: str,
    out_dir: str,
    target_col: str = "who_idh_mutation_status",
) -> Tuple[List[str], List[Tuple[str, int]]]:
    """EGD split pickles from the radiologist CSV (egd_split.py:40-76)."""
    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    # Subject MUST parse as str (reference egd_split.py:41-44): numeric ids
    # would otherwise lose their zero-padding and never match MR_* dirs
    df = pd.read_csv(csv_path, index_col=0, usecols=["Subject", target_col],
                     dtype={"Subject": str})

    ssl_scans, labelled, all_scans = [], [], []
    for name in df.index:
        label = df.loc[name].item()
        if np.isnan(label):
            raise ValueError(f"missing label for {name}")
        scan = f"MR_{name}"
        if label == -1:
            ssl_scans.append(scan)
        else:
            labelled.append((scan, int(label)))
        all_scans.append(scan)
    assert not set(ssl_scans) & {s for s, _ in labelled}, "SSL/labelled overlap"

    def valid(scans, has_labels):
        keep = []
        for item in scans:
            scan = item[0] if has_labels else item
            if all(
                os.path.exists(os.path.join(scans_root, scan, f"{m}.npy")) for m in MODALITIES
            ):
                keep.append(item)
            else:
                print(f"Skipping {scan}: missing modality files")
        return keep

    ssl_scans = valid(ssl_scans, has_labels=False)
    labelled = valid(labelled, has_labels=True)

    # JSON, not pickle: the reference writes these lists as pickles
    # (egd_split.py:69-76), but pickle is an arbitrary-code-execution format
    # and the data is plain strings/ints. The dataset reads the .json sidecar
    # preferentially and still accepts reference-made .pkl (egd.py::
    # load_split_list), so old split dirs keep working unchanged.
    _write_split_json(os.path.join(out_dir, f"{target_col}_ssl.json"), ssl_scans)
    _write_split_json(
        os.path.join(out_dir, f"{target_col}_annotated_mit_labels.json"), labelled
    )
    _write_split_json(os.path.join(out_dir, f"{target_col}_all.json"), all_scans)
    return ssl_scans, labelled


def _write_split_json(path: str, items) -> None:
    import json

    with open(path, "w") as f:
        json.dump([list(i) if isinstance(i, tuple) else i for i in items], f)


def refine_1p19q_scans(out_dir: str) -> None:
    """Remove 1p19q-labelled scans the IDH-SSL pool has seen
    (egd_split.py:79-90). Reads JSON sidecars or reference pickles;
    writes the refined list as JSON."""
    from vit_ae_plus_plus_torch.data.egd import load_split_list

    ssl_seen = set(
        load_split_list(os.path.join(out_dir, "who_idh_mutation_status_ssl.pkl"))
    )
    labelled = load_split_list(
        os.path.join(out_dir, "who_1p19q_codeletion_annotated_mit_labels.pkl")
    )
    refined = [item for item in labelled if item[0] not in ssl_seen]
    _write_split_json(
        os.path.join(out_dir, "correct_who_1p19q_codeletion_annotated_mit_labels.json"),
        refined,
    )


def kfold_indices(
    labels: np.ndarray, n_splits: int, index_dir: Optional[str] = None
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Stratified k-fold with persisted per-fold indices for restart safety
    (reference k_fold_…_brats.py:111-125)."""
    if index_dir is not None:
        os.makedirs(index_dir, exist_ok=True)
    folds = []
    for idx, (train_ids, test_ids) in enumerate(stratified_kfold(labels, n_splits)):
        if index_dir is not None:
            # persisted as .npy (allow_pickle stays False); the extensionless
            # names are the reference's own pickled fold indices
            # (k_fold_…_brats.py:113-125) — read for resume compat, never
            # written anew
            tr_path = os.path.join(index_dir, f"train_{idx}")
            te_path = os.path.join(index_dir, f"test_{idx}")
            if os.path.exists(tr_path + ".npy") and os.path.exists(te_path + ".npy"):
                train_ids = np.load(tr_path + ".npy")
                test_ids = np.load(te_path + ".npy")
            elif os.path.exists(tr_path) and os.path.exists(te_path):
                with open(tr_path, "rb") as f:
                    train_ids = pickle.load(f)
                with open(te_path, "rb") as f:
                    test_ids = pickle.load(f)
            else:
                np.save(tr_path + ".npy", np.asarray(train_ids))
                np.save(te_path + ".npy", np.asarray(test_ids))
        folds.append((np.asarray(train_ids), np.asarray(test_ids)))
    return folds
