"""3D patchification.

The patch-vector layout is (dz, dy, dx, channel) with channel fastest, the
same as the JAX package's ops/patches.py, so a patch-embed weight and a
token sequence mean the same thing in both packages.
"""

from __future__ import annotations

import torch


def patch_grid_size(volume_size: int, patch_size: int) -> int:
    """Patches per spatial axis; volumes are cubic."""
    if volume_size % patch_size != 0:
        raise ValueError(f"volume_size {volume_size} not divisible by patch_size {patch_size}")
    return volume_size // patch_size


def patchify(volume: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, C, S, S, S) -> (N, L, p^3*C) with L = (S/p)^3.

    Patch raster order is (z-grid, y-grid, x-grid); within a patch
    (dz, dy, dx, c), c fastest.
    """
    n, c, s0, s1, s2 = volume.shape
    if not (s0 == s1 == s2):
        raise ValueError(f"expected cubic volume, got {tuple(volume.shape)}")
    p = patch_size
    g = patch_grid_size(s0, p)
    x = volume.reshape(n, c, g, p, g, p, g, p)
    # n c gz pz gy py gx px -> n gz gy gx pz py px c
    x = x.permute(0, 2, 4, 6, 3, 5, 7, 1)
    return x.reshape(n, g * g * g, p * p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, L, p^3*C) -> (N, C, S, S, S). Inverse of `patchify`."""
    n, l, d = x.shape
    p = patch_size
    g = round(l ** (1 / 3))
    if g * g * g != l:
        raise ValueError(f"sequence length {l} is not a cube")
    c = d // (p * p * p)
    if c * p * p * p != d:
        raise ValueError(f"patch dim {d} not divisible by p^3={p**3}")
    x = x.reshape(n, g, g, g, p, p, p, c)
    # n gz gy gx pz py px c -> n c gz pz gy py gx px
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(n, c, g * p, g * p, g * p)
