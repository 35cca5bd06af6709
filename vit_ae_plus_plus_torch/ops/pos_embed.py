"""Fixed 3D sin-cos position embeddings, built on the host in numpy.

The same table as the JAX package's ops/pos_embed.py, quirks included:
`np.meshgrid` with its default 'xy' indexing, the embedding width split into
thirds rounded up to even with the remainder on the last axis, and an
optional all-zero cls row in front.

Resizing a table to another grid is not ported: the JAX package resizes
with `jax.image.resize`, whose trilinear weights are not those of
`torch.nn.functional.interpolate`, so callers raise when the grids differ.
"""

from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) [sin | cos] embedding."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """3D sincos embedding, (G^3[, +1], embed_dim), float64."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    axes = [np.arange(grid_size, dtype=np.float32)] * 3
    grid = np.stack(np.meshgrid(*axes), axis=0)  # default 'xy' indexing
    grid = grid.reshape([3, 1, grid_size, grid_size, grid_size])

    res = embed_dim // 3
    if res % 2 != 0:
        res += 1
    factor_w = embed_dim - 2 * res
    emb = np.concatenate(
        [
            get_1d_sincos_pos_embed_from_grid(res, grid[0]),
            get_1d_sincos_pos_embed_from_grid(res, grid[1]),
            get_1d_sincos_pos_embed_from_grid(factor_w, grid[2]),
        ],
        axis=1,
    )
    if cls_token:
        emb = np.concatenate([np.zeros([1, embed_dim]), emb], axis=0)
    return emb
