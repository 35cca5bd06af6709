"""Per-sample random token masking for the masked autoencoder.

Counterpart of the JAX package's ops/masking.py: argsort uniform noise per
token, keep the first `len_keep`, and build the binary mask (0 = keep,
1 = removed) by inverse-permuting a [0...0, 1...1] template. The noise is an
input (drawn by the caller from a `torch.Generator`, or injected by the
tests), and the sorts are stable, as `jnp.argsort` is, so equal noise gives
equal permutations in both packages.
"""

from __future__ import annotations

from typing import Tuple

import torch


def random_masking(
    x: torch.Tensor, mask_ratio: float, noise: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (N, L, D), noise (N, L) -> kept tokens (N, len_keep, D), mask (N, L)
    in x's dtype (1 = removed), ids_restore (N, L), with
    len_keep = int(L * (1 - mask_ratio))."""
    n, l, d = x.shape
    len_keep = int(l * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_masked = torch.gather(x, 1, ids_keep[:, :, None].expand(-1, -1, d))
    mask = torch.ones((n, l), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0
    mask = torch.gather(mask, 1, ids_restore)
    return x_masked, mask, ids_restore


def restore_tokens(
    x_visible: torch.Tensor, mask_token: torch.Tensor, ids_restore: torch.Tensor
) -> torch.Tensor:
    """Scatter the visible tokens (N, len_keep, D), without cls, back to full
    length: mask tokens fill the removed slots, then raster order."""
    n, len_keep, d = x_visible.shape
    l = ids_restore.shape[1]
    mask_tokens = mask_token.to(x_visible.dtype).expand(n, l - len_keep, d)
    x_full = torch.cat([x_visible, mask_tokens], dim=1)
    return torch.gather(x_full, 1, ids_restore[:, :, None].expand(-1, -1, d))
