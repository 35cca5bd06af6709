"""Dataset factory.

The port's copy of the JAX package's `data/factory.py`.

Parity: reference dataset/dataset_factory.py:5-10, with paths
taken from DataConfig instead of hard-coded constants.
"""

from __future__ import annotations

import os
from typing import Optional

from vit_ae_plus_plus_torch.configs import DataConfig
from vit_ae_plus_plus_torch.data.brats import BraTSDataset
from vit_ae_plus_plus_torch.data.egd import EGDDataset


def get_dataset(
    dataset_name: str,
    mode: str,
    cfg: DataConfig,
    transforms=None,
    use_z_score: bool = False,
    split: Optional[str] = None,
):
    if dataset_name == "brats":
        return BraTSDataset(
            base_path=cfg.base_path, mode=mode, transform=transforms, use_z_score=use_z_score
        )
    if dataset_name == "egd":
        return EGDDataset(
            base_path=cfg.base_path,
            split_dir=os.path.join(cfg.base_path, "splits"),
            mode=mode,
            split=split or cfg.split,
            transform=transforms,
            use_z_score=use_z_score,
        )
    raise ValueError(f"unknown dataset {dataset_name!r}")
