"""Host-side 3D augmentations (numpy/scipy), the torchio-equivalent policy.

The port's copy of the JAX package's `data/transforms.py`, with the same
classes, parameter draws and outputs.

Parity target: the SSL augmentation policy of the reference training scripts
(k_fold_training_scripts/k_fold_cross_valid_combined_brats.py:93-97):
tio.RandomAffine(), tio.RandomNoise(std=0.1), tio.RandomGamma(log_gamma=(-0.3, 0.3)).
torchio is not a dependency here; these reimplement the same default
distributions (scales U(0.9, 1.1) per axis, rotations U(-10°, 10°) per axis,
linear resampling; noise std U(0, 0.1); gamma = exp(U(-0.3, 0.3)) applied on
the min-max-rescaled intensity as torchio does for non-negative inputs).

Augmentation is per-sample CPU work exactly as in the reference (torchio runs
in DataLoader workers there); the Loader runs these in a thread pool and
overlaps them with device compute (data/loader.py: Loader, cuda_prefetch).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy import ndimage


class Transform:
    def __call__(self, volume: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        raise NotImplementedError


class Compose(Transform):
    def __init__(self, transforms: Sequence[Transform]):
        self.transforms = list(transforms)

    def __call__(self, volume, rng):
        for t in self.transforms:
            volume = t(volume, rng)
        return volume

    def __repr__(self):
        return f"Compose({self.transforms})"


class RandomAffine3D(Transform):
    """Random scale + rotation (torchio RandomAffine defaults: scales 0.1 ->
    U(0.9, 1.1) per axis, degrees 10 -> U(-10, 10) per axis, no translation,
    linear interpolation, edge padding with 0)."""

    def __init__(self, scales: float = 0.1, degrees: float = 10.0):
        self.scales = scales
        self.degrees = degrees

    def __call__(self, volume, rng):
        c = volume.shape[0]
        scale = rng.uniform(1 - self.scales, 1 + self.scales, size=3)
        angles = rng.uniform(-self.degrees, self.degrees, size=3) * math.pi / 180.0

        def rot(axis, a):
            c_, s_ = math.cos(a), math.sin(a)
            m = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            m[i, i] = c_
            m[i, j] = -s_ if axis != 1 else s_
            m[j, i] = s_ if axis != 1 else -s_
            m[j, j] = c_
            return m

        mat = rot(0, angles[0]) @ rot(1, angles[1]) @ rot(2, angles[2]) @ np.diag(1.0 / scale)
        center = (np.asarray(volume.shape[1:]) - 1) / 2.0
        offset = center - mat @ center
        out = np.empty_like(volume)
        for i in range(c):
            out[i] = ndimage.affine_transform(
                volume[i], mat, offset=offset, order=1, mode="constant", cval=0.0
            )
        return out


class RandomNoise(Transform):
    """Gaussian noise, std ~ U(0, std) (torchio RandomNoise semantics)."""

    def __init__(self, std: float = 0.1):
        self.std = std

    def __call__(self, volume, rng):
        std = rng.uniform(0, self.std)
        return volume + rng.normal(0.0, std, size=volume.shape).astype(volume.dtype)


class RandomGamma(Transform):
    """Intensity power transform, gamma = exp(U(log_gamma)). Applied on the
    min-max-rescaled intensities then mapped back (valid for any input range;
    matches torchio's behaviour for the non-negative MRI volumes used here)."""

    def __init__(self, log_gamma=(-0.3, 0.3)):
        self.log_gamma = log_gamma

    def __call__(self, volume, rng):
        gamma = math.exp(rng.uniform(*self.log_gamma))
        vmin, vmax = float(volume.min()), float(volume.max())
        if vmax <= vmin:
            return volume
        unit = (volume - vmin) / (vmax - vmin)
        return (unit**gamma * (vmax - vmin) + vmin).astype(volume.dtype)


class RandomBlur(Transform):
    """Gaussian blur with per-axis std ~ U(0, 2) (torchio RandomBlur default);
    appears in the reference dataset __main__ demos (brats.py:61-66)."""

    def __init__(self, std: float = 2.0):
        self.std = std

    def __call__(self, volume, rng):
        stds = rng.uniform(0, self.std, size=3)
        out = np.empty_like(volume)
        for i in range(volume.shape[0]):
            out[i] = ndimage.gaussian_filter(volume[i], sigma=stds)
        return out


def default_ssl_transforms(native: str = "auto") -> Compose:
    """The pretraining policy (k_fold_…_brats.py:93-97).

    `native='auto'` uses the C++ kernels (native/augment3d.cpp via
    data/native_augment.py — same parameter distributions, ~20x faster per
    volume) when the library builds on this machine, scipy otherwise;
    'never' forces scipy, 'require' raises if the library is unavailable.
    """
    if native != "never":
        from vit_ae_plus_plus_torch.data import native_augment as na

        if na.available():
            return Compose([
                na.NativeRandomAffine3D(),
                na.NativeRandomNoise(std=0.1),
                na.NativeRandomGamma((-0.3, 0.3)),
            ])
        if native == "require":
            raise RuntimeError("native augmentation library unavailable (no g++?)")
    return Compose([RandomAffine3D(), RandomNoise(std=0.1), RandomGamma((-0.3, 0.3))])
