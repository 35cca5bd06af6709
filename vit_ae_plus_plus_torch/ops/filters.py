"""Constant-kernel 3D filters of the edge-map loss.

Counterpart of the JAX package's ops/filters.py: Sobel gradient magnitude
(summed over channels) and a Gaussian blur whose taps are the reference's
linspace at spacing 1.2, both run as separable 1-D passes, each a product
with a banded matrix M[j, i] = taps[j - i + pad] (zero padding). Products
stay out of cuDNN, so f32 stays f32 on the card (cuDNN's f32 convolutions
default to TF32; matmuls do not).

The `*_conv` and `*_dense` variants are the reference's own stock
convolutions (sobel_filter.py:12-45, gaussian_filter.py:16-26), kept for
cross-checks and for the reference-faithful step (utils/ref_faithful.py):
`F.conv3d` on the tensor's device, f32 without TF32 on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# separable Sobel factors: each axis's kernel is the outer product of the
# derivative on that axis and the smoothing on the other two
_SMOOTH = (1.0, 2.0, 1.0)
_DERIV = (1.0, 0.0, -1.0)

# the dense Sobel kernels, axis order (z, y, x) as the reference's weight[0..2, 0]
_SOBEL_X = np.array(
    [
        [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
        [[2, 0, -2], [4, 0, -4], [2, 0, -2]],
        [[1, 0, -1], [2, 0, -2], [1, 0, -1]],
    ],
    dtype=np.float32,
)
_SOBEL_Y = np.array(
    [
        [[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
        [[-2, -4, -2], [0, 0, 0], [2, 4, 2]],
        [[-1, -2, -1], [0, 0, 0], [1, 2, 1]],
    ],
    dtype=np.float32,
)
_SOBEL_Z = np.array(
    [
        [[-1, -2, -1], [-2, -4, -2], [-1, -2, -1]],
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
        [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
    ],
    dtype=np.float32,
)
_SOBEL_KERNEL = np.stack([_SOBEL_X, _SOBEL_Y, _SOBEL_Z])[:, None]  # (3, 1, 3, 3, 3) OIDHW

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


def _conv3d(x: torch.Tensor, kernel: np.ndarray, padding) -> torch.Tensor:
    """`F.conv3d` (a cross-correlation, as lax.conv) of (N, 1, Z, Y, X) with
    a constant OIDHW kernel, in x's dtype; cuDNN without TF32."""
    w = torch.as_tensor(kernel).to(x.device, x.dtype)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv3d(x, w, padding=padding)


def sobel_edges_3d_conv(volume: torch.Tensor) -> torch.Tensor:
    """`sobel_edges_3d` as the reference computes it: one 1 -> 3-channel 3^3
    convolution per input channel, 'same' zero padding."""
    n, c, *spatial = volume.shape
    g = _conv3d(volume.reshape(n * c, 1, *spatial), _SOBEL_KERNEL, 1)
    mag = _edge_magnitude(torch.sum(g * g, dim=1))
    return mag.reshape(n, c, *spatial).sum(dim=1)


def gaussian_blur_3d_conv(volume: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """`gaussian_blur_3d` as three 1-D convolutions, one per axis."""
    k = gaussian_kernel_1d(sigma)
    pad = len(k) // 2
    n, c, *spatial = volume.shape
    x = volume.reshape(n * c, 1, *spatial)
    for axis in range(3):
        shape = [1, 1, 1, 1, 1]
        shape[2 + axis] = len(k)
        padding = tuple(pad if i == axis else 0 for i in range(3))
        x = _conv3d(x, k.reshape(shape), padding)
    return x.reshape(n, c, *spatial)


def gaussian_blur_3d_dense(volume: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """The reference's own algorithm (gaussian_filter.py:16-26): one dense
    k^3 convolution per channel with the outer-product kernel k (x) k (x) k,
    renormalised, padding len(k) // 2: 1,331 MACs a voxel at sigma 2
    against the separable path's 33. Only the reference-faithful step
    (utils/ref_faithful.py) uses it."""
    k = gaussian_kernel_1d(sigma)
    k3d = np.einsum("i,j,k->ijk", k, k, k)
    k3d = k3d / k3d.sum()
    pad = len(k) // 2
    n, c, *spatial = volume.shape
    x = _conv3d(volume.reshape(n * c, 1, *spatial), k3d[None, None], pad)
    return x.reshape(n, c, *spatial)
