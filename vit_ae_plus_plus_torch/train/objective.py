"""The ViT-AE++ composite objective.

Counterpart of the JAX package's train/objective.py (`mae_loss_terms`),
with its quirks kept: the Sobel map of the RAW prediction is compared with
that of the BLURRED target; the reconstruction is averaged over removed
patches only (computed in volume space when `norm_pix_loss` is off); the
contrastive term is per token, cls included; the perceptual (VGG) term,
computed on the (normalised, under `norm_pix_loss`) target volume, is
logged but gradient-free by default (the reference's `torch.no_grad()`,
vit_autoenc.py:229-230, the JAX package's `stop_gradient`): it runs under
`torch.no_grad()`, so the VGG's activations never join the step's graph.
`perceptual_differentiable=True` is the opt-in that lets its gradient
through.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from vit_ae_plus_plus_torch.models.vit import compute_dtype
from vit_ae_plus_plus_torch.ops import (
    at_least_f32,
    edge_map_loss,
    gaussian_blur_3d,
    masked_mse_loss,
    negative_cosine_loss,
    patchify,
    sobel_edges_3d,
    unpatchify,
)


def mae_loss_terms(
    outputs: Dict[str, torch.Tensor],
    view1: torch.Tensor,
    patch_size: int,
    *,
    edge_map_weight: Union[torch.Tensor, float] = 0.0,
    contr_weight: float = 0.0,
    perceptual_weight: float = 0.0,
    norm_pix_loss: bool = False,
    perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    perceptual_differentiable: bool = False,
    filters_dtype: str = "float32",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Model outputs + input -> (total loss, metrics): `loss`,
    `edge_map_loss` (unweighted), `reconstruction_loss`, `perceptual_loss`
    and `contr_loss` (weighted). The perceptual term is 0 unless both
    `perceptual_fn` (models/vgg.py `make_perceptual_fn`) and
    `perceptual_weight` are given."""
    pred, mask = outputs["pred"], outputs["mask"]
    pred_f = at_least_f32(pred)
    pred_vol = unpatchify(pred_f, patch_size)
    if norm_pix_loss:
        target = at_least_f32(patchify(view1, patch_size))
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / (var + 1.0e-6) ** 0.5
        target_vol = unpatchify(target, patch_size)
        recon = masked_mse_loss(pred_f, target, mask)
    else:
        # the per-patch-mean masked MSE as a voxel-space masked sum
        target_vol = view1
        b, s, p = mask.shape[0], view1.shape[-1], patch_size
        g = s // p
        mask_f = at_least_f32(mask)
        mask_vox = (
            mask_f.reshape(b, 1, g, 1, g, 1, g, 1)
            .expand(b, 1, g, p, g, p, g, p)
            .reshape(b, 1, s, s, s)
        )
        sq = (pred_vol - at_least_f32(view1)) ** 2
        recon = (sq * mask_vox).sum() / (mask_f.sum() * p**3 * pred_vol.shape[1])

    fdt = compute_dtype(filters_dtype)
    pred_edges = sobel_edges_3d(pred_vol.to(fdt))
    target_edges = sobel_edges_3d(gaussian_blur_3d(target_vol.to(fdt), 2.0))
    raw_edge = edge_map_loss(pred_edges, target_edges)
    edge_loss = edge_map_weight * raw_edge

    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    if perceptual_fn is not None and perceptual_weight:
        if perceptual_differentiable:
            percep = perceptual_weight * perceptual_fn(pred_vol, target_vol)
        else:
            with torch.no_grad():
                percep = perceptual_weight * perceptual_fn(pred_vol.detach(), target_vol.detach())
    else:
        percep = zero
    if contr_weight and "p1" in outputs:
        contr = contr_weight * negative_cosine_loss(
            outputs["p1"], outputs["p2"], outputs["z1"], outputs["z2"]
        )
    else:
        contr = zero
    total = edge_loss + recon + percep + contr
    metrics = {
        "loss": total,
        "edge_map_loss": raw_edge,
        "reconstruction_loss": recon,
        "perceptual_loss": percep,
        "contr_loss": contr,
    }
    return total, metrics
