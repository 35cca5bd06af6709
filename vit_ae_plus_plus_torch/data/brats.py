"""BraTS dataset source.

The port's copy of the JAX package's `data/brats.py`: the same items from
the same files under the same per-(item, access) generator.

Parity: reference dataset/brats_dataset/brats.py:12-57 —
one monolithic `x_{mode}_ssl.npy` of shape (N, S, S, S, 1), channel-last on
disk, transposed to channel-first; items are (augmented, original, label)
where the augmentation runs on the RAW volume and BOTH copies are normalised
afterwards (brats.py:39-47). Normalisation: per-volume z-score (population
variance) or min-max to [-1, 1] (brats.py:26-32).

Deltas from the reference: the array is memory-mapped instead of loaded into RAM, and
the base path is a constructor argument instead of a hard-coded constant
(brats.py:10).
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import numpy as np

from vit_ae_plus_plus_torch.data.transforms import Transform


def normalize_volume(volume: np.ndarray, use_z_score: bool) -> np.ndarray:
    """Whole-volume normalisation (reference brats.py:26-32)."""
    volume = volume.astype(np.float32)
    if use_z_score:
        return (volume - volume.mean()) / np.sqrt(volume.var())
    vmax, vmin = volume.max(), volume.min()
    volume = (volume - vmin) / (vmax - vmin)
    return 2 * volume - 1


class BraTSDataset:
    """Single-modality (FLAIR) 3D volumes with SSL 3-tuple contract."""

    def __init__(
        self,
        base_path: str,
        mode: str = "whole",
        transform: Optional[Transform] = None,
        use_z_score: bool = False,
        seed: int = 0,
        raw: bool = False,
    ):
        if mode not in ("train", "val", "test", "whole"):
            raise ValueError(f"invalid mode {mode!r}")
        self.data = np.load(os.path.join(base_path, f"x_{mode}_ssl.npy"), mmap_mode="r")
        label_path = os.path.join(base_path, f"y_{mode}_ssl.npy")
        self.labels = np.load(label_path) if os.path.exists(label_path) else None
        self.transform = transform
        self.use_z_score = use_z_score
        self.raw = raw  # skip normalisation+augmentation: device-side augment path
        self._seed = seed
        self._access_lock = threading.Lock()
        self._access_counts: dict = {}

    def __len__(self) -> int:
        return self.data.shape[0]

    def __getitem__(self, item: int) -> Tuple[np.ndarray, np.ndarray, int]:
        # disk layout (S, S, S, C) -> channel-first (C, S, S, S) (brats.py:17)
        volume = np.ascontiguousarray(
            np.asarray(self.data[item], dtype=np.float32).transpose(3, 0, 1, 2)
        )
        if self.raw:
            label = int(self.labels[item]) if self.labels is not None else -100
            return volume, volume, label
        original = normalize_volume(volume, self.use_z_score)
        if self.transform is not None:
            # deterministic per-(item, access#) stream: reproducible regardless
            # of loader-thread interleaving, fresh draws every epoch
            with self._access_lock:
                count = self._access_counts[item] = self._access_counts.get(item, 0) + 1
            rng = np.random.default_rng([self._seed, item, count])
            volume = self.transform(volume, rng)
        augmented = normalize_volume(volume, self.use_z_score)
        label = int(self.labels[item]) if self.labels is not None else -100
        return augmented, original, label

    def __repr__(self):
        return f"BraTSDataset(n={len(self)}, transform={self.transform})"
