"""Local-binary-pattern texture histogram: the port's copy of the JAX
package's ops/lbp.py.

Parity target: reference model/model_utils/lbp_python.py:7-15, which calls
skimage's `_local_binary_pattern(P=8, R=1, method='D')`. The reference
passes a 3D volume to a strictly 2D kernel, so its module fails at import,
and nothing imports it (a dead standalone experiment); here, as in the JAX
package, the volume is coded slice by slice. Method 'D' is the raw
rotation-variant 8-bit code with bilinearly interpolated circle
neighbours, computed with rolled copies of the slice (edges wrap, which
touches only the one-pixel border).

Kept for parity with the JAX package only: nothing in the port calls it,
and it is not exported from `ops` (ROADMAP Queue 3, dead parity code).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _neighbor_value(img: torch.Tensor, dy: float, dx: float) -> torch.Tensor:
    """The bilinearly interpolated neighbour at (row + dy, col + dx)."""
    y0, x0 = math.floor(dy), math.floor(dx)
    fy, fx = dy - y0, dx - x0
    v00 = torch.roll(img, (-y0, -x0), dims=(0, 1))
    if abs(fy) < 1e-9 and abs(fx) < 1e-9:
        return v00
    v01 = torch.roll(img, (-y0, -(x0 + 1)), dims=(0, 1))
    v10 = torch.roll(img, (-(y0 + 1), -x0), dims=(0, 1))
    v11 = torch.roll(img, (-(y0 + 1), -(x0 + 1)), dims=(0, 1))
    return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx


def local_binary_pattern_2d(image: torch.Tensor, P: int = 8, R: float = 1.0) -> torch.Tensor:
    """Rotation-variant ('D') LBP codes of one 2D image."""
    code = torch.zeros(image.shape, dtype=torch.int32, device=image.device)
    threshold = image - torch.tensor(1e-12, dtype=image.dtype)  # skimage's >= with a rounding guard
    for p in range(P):
        angle = 2 * math.pi * p / P
        neigh = _neighbor_value(image, -R * math.sin(angle), R * math.cos(angle))
        code = code + (2**p) * (neigh >= threshold).to(torch.int32)
    return code


def lbp_histogram(volume: np.ndarray, P: int = 8, R: float = 1.0) -> np.ndarray:
    """The density-normalised 2^P-bin histogram of the per-slice LBP codes
    (lbp_python.py:7-12, made to work on volumes)."""
    vol = torch.as_tensor(np.asarray(volume, np.float64 if volume.dtype == np.float64 else np.float32))
    if vol.ndim == 2:
        vol = vol[None]
    codes = torch.stack([local_binary_pattern_2d(vol[z], P, R) for z in range(vol.shape[0])])
    hist, _ = np.histogram(codes.numpy(), bins=np.arange(2**P + 1), density=True)
    return hist
