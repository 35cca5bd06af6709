"""EGD glioma dataset source.

The port's copy of the JAX package's `data/egd.py`.

Parity: reference dataset/egd_dataset/egd.py:15-84 —
per-scan directories holding 4 modality arrays stacked [flair, t1ce, t1, t2];
split membership from pickled scan-name lists keyed by mode (ssl / test /
whole / whole_train) x split (idh / 1p19q); labels only in 'test' mode, else
sentinel -100 (egd.py:71); per-CHANNEL z-score over spatial dims (egd.py:44-47)
— unlike BraTS's whole-volume normalisation.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Optional, Tuple

import numpy as np

from vit_ae_plus_plus_torch.data.transforms import Transform

MODALITIES = ("flair", "t1ce", "t1", "t2")

IDH_MODE_FILENAMES = {
    "ssl": "who_idh_mutation_status_ssl.pkl",
    "test": "who_idh_mutation_status_annotated_mit_labels.pkl",
    "whole": "who_idh_mutation_status_all.pkl",
    "whole_train": "who_idh_mutation_status_all_train.pkl",
}


def split_filename(mode: str, split: str = "idh") -> str:
    """Split-pickle naming scheme (reference egd.py:19-39)."""
    if split == "idh":
        return IDH_MODE_FILENAMES[mode]
    if split == "1p19q":
        return (
            "who_1p19q_codeletion_ssl.pkl"
            if mode == "ssl"
            else "correct_who_1p19q_codeletion_annotated_mit_labels.pkl"
        )
    raise ValueError(f"invalid split {split!r}")


def load_split_list(pkl_path: str):
    """Load a split list, preferring the JSON sidecar over the legacy pickle.

    This framework's bootstrap (data/splits.py) writes `.json` sidecars —
    pickle is an arbitrary-code-execution format and nothing here needs it.
    The `.pkl` path is still honoured so split directories produced by the
    reference's own bootstrap (egd_split.py:69-76) load unchanged. Labelled
    entries arrive as (scan, label) tuples from pickle and [scan, label]
    lists from JSON; consumers index item[0]/item[1], which both satisfy.
    """
    import json

    json_path = os.path.splitext(pkl_path)[0] + ".json"
    if os.path.exists(json_path):
        with open(json_path) as f:
            return json.load(f)
    with open(pkl_path, "rb") as f:
        return pickle.load(f)


def normalize_per_channel(volume: np.ndarray, use_z_score: bool) -> np.ndarray:
    """Per-channel z-score over spatial dims, or whole-volume min-max
    (reference egd.py:44-50)."""
    volume = volume.astype(np.float32)
    if use_z_score:
        mean = volume.mean(axis=(1, 2, 3), keepdims=True)
        var = volume.var(axis=(1, 2, 3), keepdims=True)
        return (volume - mean) / np.sqrt(var)
    vmax, vmin = volume.max(), volume.min()
    volume = (volume - vmin) / (vmax - vmin)
    return 2 * volume - 1


class EGDDataset:
    def __init__(
        self,
        base_path: str,
        split_dir: str,
        mode: str = "whole",
        split: str = "idh",
        transform: Optional[Transform] = None,
        use_z_score: bool = False,
        seed: int = 0,
        raw: bool = False,
    ):
        if mode not in ("ssl", "test", "whole", "whole_train"):
            raise ValueError(f"invalid mode {mode!r}")
        self.base_path = base_path
        self.indices = load_split_list(
            os.path.join(split_dir, split_filename(mode, split))
        )
        self.has_labels = mode == "test"
        self.raw = raw  # skip normalisation+augmentation: device-side augment path
        self.transform = transform
        self.use_z_score = use_z_score
        self._seed = seed
        self._access_lock = threading.Lock()
        self._access_counts: dict = {}

    def __len__(self) -> int:
        return len(self.indices)

    def load_volume(self, scan_name: str) -> np.ndarray:
        return np.stack(
            [
                np.load(os.path.join(self.base_path, scan_name, f"{m}.npy"))
                for m in MODALITIES
            ]
        )

    def count_access(self, item: int, n: int = 1) -> None:
        """Move `item`'s access count by `n` without loading it: a loader
        whose ranks share a global batch counts the other ranks' rows, so
        each item's augmentation stream stays a one-process run's."""
        with self._access_lock:
            self._access_counts[item] = self._access_counts.get(item, 0) + n

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray, int]:
        if self.has_labels:
            scan, label = self.indices[item][0], int(self.indices[item][1])
        else:
            scan, label = self.indices[item], -100
        volume = self.load_volume(scan).astype(np.float32)
        if self.raw:
            return volume, volume, label
        original = normalize_per_channel(volume, self.use_z_score)
        if self.transform is not None:
            # deterministic per-(item, access#) stream: reproducible regardless
            # of loader-thread interleaving, fresh draws every epoch
            with self._access_lock:
                count = self._access_counts[item] = self._access_counts.get(item, 0) + 1
            rng = np.random.default_rng([self._seed, item, count])
            volume = self.transform(volume, rng)
        augmented = normalize_per_channel(volume, self.use_z_score)
        return augmented, original, label

    def __repr__(self):
        return f"EGDDataset(n={len(self)}, transform={self.transform})"
