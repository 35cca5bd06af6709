"""Fixed 3D sin-cos position embeddings, built on the host in numpy.

The same table as the JAX package's ops/pos_embed.py, quirks included:
`np.meshgrid` with its default 'xy' indexing, the embedding width split into
thirds rounded up to even with the remainder on the last axis, and an
optional all-zero cls row in front.

`interpolate_pos_embed` resizes a table to another cubic grid as the JAX
package does, through `resize_trilinear` (ops/resize.py), which keeps the
weights of `jax.image.resize`; `torch.nn.functional.interpolate`'s are
others.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_ae_plus_plus_torch.ops.resize import resize_trilinear


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


def _cube_root(count: int, what: str) -> int:
    size = round(count ** (1 / 3))
    if size**3 != count:
        raise ValueError(f"{what} {count} is not a cube")
    return size


def interpolate_pos_embed(pos_embed: torch.Tensor, new_num_patches: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """A (1, T, D) table resized to a cubic grid of `new_num_patches`: the
    extra (cls) tokens are kept, the grid tokens resized trilinearly (the
    JAX package's `interpolate_pos_embed`). The table comes back as it is
    when the grids agree, else in f32."""
    embed_dim = pos_embed.shape[-1]
    orig_size = _cube_root(pos_embed.shape[-2] - num_extra_tokens, "the table's grid token count")
    new_size = _cube_root(new_num_patches, "new_num_patches")
    if orig_size == new_size:
        return pos_embed
    extra = pos_embed[:, :num_extra_tokens].float()
    grid = pos_embed[:, num_extra_tokens:].reshape(1, orig_size, orig_size, orig_size, embed_dim)
    grid = resize_trilinear(grid, (1, new_size, new_size, new_size, embed_dim))
    return torch.cat([extra, grid.reshape(1, new_size**3, embed_dim)], dim=1)
