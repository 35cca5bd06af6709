"""The host data path: datasets, augmentations, splits and the loader (the
port's copy of the JAX package's `data/`, with the same exports)."""

from vit_ae_plus_plus_torch.data.transforms import (
    Compose,
    RandomAffine3D,
    RandomGamma,
    RandomNoise,
    default_ssl_transforms,
)
from vit_ae_plus_plus_torch.data.brats import BraTSDataset
from vit_ae_plus_plus_torch.data.egd import EGDDataset
from vit_ae_plus_plus_torch.data.factory import get_dataset
from vit_ae_plus_plus_torch.data.loader import Loader, all_items

__all__ = [
    "Compose",
    "RandomAffine3D",
    "RandomGamma",
    "RandomNoise",
    "default_ssl_transforms",
    "BraTSDataset",
    "EGDDataset",
    "get_dataset",
    "Loader",
    "all_items",
]
