"""Constant-kernel 3D filters of the edge-map loss.

Counterpart of the JAX package's ops/filters.py: Sobel gradient magnitude
(summed over channels) and a Gaussian blur whose taps are the reference's
linspace at spacing 1.2, both run as separable 1-D passes, each a product
with a banded matrix M[j, i] = taps[j - i + pad] (zero padding). Products
stay out of cuDNN, so f32 stays f32 on the card (cuDNN's f32 convolutions
default to TF32; matmuls do not).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# separable Sobel factors: each axis's kernel is the outer product of the
# derivative on that axis and the smoothing on the other two
_SMOOTH = (1.0, 2.0, 1.0)
_DERIV = (1.0, 0.0, -1.0)

_AXIS_EINSUM = {0: "bczyx,zw->bcwyx", 1: "bczyx,yw->bczwx", 2: "bczyx,xw->bczyw"}


def band_matrix(taps: np.ndarray, size: int) -> np.ndarray:
    """M[j, i] = taps[j - i + pad]: right-multiplying applies the 1-D
    cross-correlation with zero padding along that axis."""
    taps = np.asarray(taps, np.float32)
    pad = len(taps) // 2
    j = np.arange(size)[:, None]
    i = np.arange(size)[None, :]
    k = j - i + pad
    return np.where((k >= 0) & (k < len(taps)), taps[np.clip(k, 0, len(taps) - 1)], 0.0)


@functools.lru_cache(maxsize=64)
def _band(taps: tuple, size: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The band matrix as a tensor, built once per (taps, size, dtype,
    device) so that a training step copies nothing to the device."""
    return torch.as_tensor(band_matrix(np.asarray(taps, np.float32), size)).to(device, dtype)


def _apply_1d(vol: torch.Tensor, taps: tuple, axis: int) -> torch.Tensor:
    """1-D cross-correlation along spatial `axis` of (N, C, Z, Y, X)."""
    m = _band(taps, vol.shape[2 + axis], vol.dtype, vol.device)
    return torch.einsum(_AXIS_EINSUM[axis], vol, m)


def _edge_magnitude(sq_sum: torch.Tensor) -> torch.Tensor:
    """sqrt with the subgradient 0 at 0: a bare sqrt has an infinite
    gradient where the volume is locally flat, which turns the whole step to
    NaN. The forward value is unchanged."""
    positive = sq_sum > 0
    safe = torch.where(positive, sq_sum, torch.ones_like(sq_sum))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(sq_sum))


def sobel_edges_3d(volume: torch.Tensor) -> torch.Tensor:
    """(N, C, S, S, S) -> (N, S, S, S): per channel sqrt(gx^2 + gy^2 + gz^2),
    summed over channels."""
    sz = _apply_1d(volume, _SMOOTH, 0)
    sy = _apply_1d(volume, _SMOOTH, 1)
    gx = _apply_1d(_apply_1d(sz, _SMOOTH, 1), _DERIV, 2)
    gy = _apply_1d(_apply_1d(sz, _DERIV, 1), _SMOOTH, 2)
    gz = _apply_1d(_apply_1d(sy, _DERIV, 0), _SMOOTH, 2)
    return _edge_magnitude(gx * gx + gy * gy + gz * gz).sum(dim=1)


def gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """1-D taps as the reference makes them: `ks = int(5 sigma)` made odd,
    a float32 linspace from -ks//2 to ks//2 + 1 (11 taps 1.2 apart on
    [-6, 6] at sigma 2), normalised."""
    ks = int(sigma * 5)
    if ks % 2 == 0:
        ks += 1
    ts = np.linspace(-ks // 2, ks // 2 + 1, ks, dtype=np.float32)
    gauss = np.exp(-((ts / sigma) ** 2) / 2.0)
    return gauss / gauss.sum()


def gaussian_blur_3d(volume: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """(N, C, S, S, S) -> same shape, per-channel separable Gaussian blur."""
    taps = tuple(gaussian_kernel_1d(sigma).tolist())
    x = volume
    for axis in range(3):
        x = _apply_1d(x, taps, axis)
    return x
