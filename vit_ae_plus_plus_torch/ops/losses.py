"""Loss terms of the ViT-AE++ composite objective.

Counterpart of the JAX package's ops/losses.py, with the supervised
downstream losses (`soft_cross_entropy_with_weights`, and `weighted_ce` from
the JAX package's pipelines/finetune.py). Reductions run in at least f32
whatever the compute dtype; f64 stays f64 (the CPU trajectory tests).
"""

from __future__ import annotations

from typing import Optional

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


def soft_cross_entropy_with_weights(
    logits: torch.Tensor, soft_targets: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Class-weighted soft-target cross entropy with the reference's own
    reduction (utils/custom_loss.py:7-18, through the JAX package):
    sum over the batch and classes of -t * w * log_softmax(x), divided by
    C * sum(w)."""
    logits = at_least_f32(logits)
    log_probs = logits - logits.amax(dim=-1, keepdim=True)
    log_probs = log_probs - torch.log(torch.exp(log_probs).sum(dim=-1, keepdim=True))
    if weights is None:
        weights = torch.ones(logits.shape[-1], dtype=logits.dtype, device=logits.device)
    else:
        weights = at_least_f32(weights).to(logits.dtype)
    num_classes = logits.shape[-1]
    total = (-at_least_f32(soft_targets).to(logits.dtype) * log_probs * weights[None, :]).sum()
    return total / (weights.sum() * num_classes)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, class_weights: torch.Tensor,
                weight_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`torch.nn.CrossEntropyLoss(weight=w)` semantics: per-sample weighted
    NLL over the sum of the samples' weights, in at least f32. `weight_sum`
    replaces that denominator (a data-parallel step's shard passes the
    global batch's sum)."""
    logits = at_least_f32(logits)
    nll = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    w = class_weights[labels]
    return (nll * w).sum() / (w.sum() if weight_sum is None else weight_sum)
