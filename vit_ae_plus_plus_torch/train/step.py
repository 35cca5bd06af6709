"""Inference steps (counterpart of the JAX package's train/step.py)."""

from __future__ import annotations

import torch

from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D


def feature_step(model: VisionTransformer3D, batch: torch.Tensor) -> torch.Tensor:
    """Batched encoder inference: `forward_features` with autograd off."""
    with torch.inference_mode():
        return model.forward_features(batch)
