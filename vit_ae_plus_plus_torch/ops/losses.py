"""Loss terms of the ViT-AE++ composite objective.

Counterpart of the JAX package's ops/losses.py. Reductions run in at least
f32 whatever the compute dtype; f64 stays f64 (the CPU trajectory tests).
"""

from __future__ import annotations

import torch


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast sub-f32 inputs (bf16) to f32; leave f32 and f64 as they are."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-patch mean squared error, averaged over removed patches only
    (mask 1 = removed)."""
    pred, target, mask = at_least_f32(pred), at_least_f32(target), at_least_f32(mask)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    return (per_patch * mask).sum() / mask.sum()


def edge_map_loss(pred_edges: torch.Tensor, target_edges: torch.Tensor) -> torch.Tensor:
    """Plain mean squared error between edge maps."""
    diff = at_least_f32(pred_edges) - at_least_f32(target_edges)
    return (diff * diff).mean()


def negative_cosine_loss(p1, p2, z1, z2, eps: float = 1e-8) -> torch.Tensor:
    """SimSiam symmetric negative cosine similarity over rows. Each norm is
    clamped at `eps` on its own, as the JAX package does (not
    `F.cosine_similarity`, which clamps their product). z1 and z2 come
    detached from the model."""

    def _cos(a, b):
        a, b = at_least_f32(a), at_least_f32(b)
        na = torch.clamp_min(torch.linalg.vector_norm(a, dim=1), eps)
        nb = torch.clamp_min(torch.linalg.vector_norm(b, dim=1), eps)
        return (a * b).sum(dim=1) / (na * nb)

    return -(_cos(p1, z2).mean() + _cos(p2, z1).mean()) * 0.5
