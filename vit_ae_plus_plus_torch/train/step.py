"""The SSL training step and the inference step.

Counterpart of the JAX package's train/step.py: `make_train_step` builds
forward, composite loss, backward, global-norm metric and AdamW update as
one call; `feature_step` is batched encoder inference. PyTorch runs
eagerly, so the step is a plain function over a mutable `TrainState`.

The JAX step shards the batch over the mesh's 'data' axis and so takes the
gradient and the contrastive BatchNorm's statistics over the global batch.
The port reduces neither over a data group yet (data parallelism is its own
later work), so its step refuses an ambient mesh with data > 1 before any
forward, rather than let each data coordinate take its own update. A mesh
of (1, M), as the sequence-parallel attention paths train on, and no mesh
at all run as before.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D
from vit_ae_plus_plus_torch.ops import at_least_f32
from vit_ae_plus_plus_torch.parallel import get_mesh
from vit_ae_plus_plus_torch.train.objective import mae_loss_terms
from vit_ae_plus_plus_torch.train.optim import global_norm
from vit_ae_plus_plus_torch.train.state import TrainState

# forward_fn(model, view1, view2, generator) -> outputs dict
ForwardFn = Callable[[torch.nn.Module, torch.Tensor, Optional[torch.Tensor], torch.Generator], Dict]


def make_train_step(
    model,
    patch_size: int,
    *,
    mask_ratio: float = 0.75,
    contr_weight: float = 0.0,
    perceptual_weight: float = 0.0,
    norm_pix_loss: bool = False,
    loss_filters_dtype: str = "float32",
    forward_fn: Optional[ForwardFn] = None,
) -> Callable:
    """Build `train_step(state, view1, view2, edge_map_weight) ->
    (state, metrics)`.

    `edge_map_weight` is a run-time scalar (the per-epoch schedule).
    The masking noise of the 2B encoded rows (B without contrast) comes from
    the state's generator; `forward_fn(model, view1, view2, generator)`
    replaces the model call, e.g. to inject noise in tests. `metrics` holds
    the loss terms and `grad_norm` (the global norm of all gradients before
    clipping) as device scalars, so the step does not wait for the card.

    The step raises `ValueError` under a `parallel.set_mesh` mesh whose
    'data' axis has more than one rank (see the module's docstring)."""
    contrastive = model.cfg.contrastive

    if forward_fn is None:

        def forward_fn(m, view1, view2, generator):
            return m(view1, view2, mask_ratio=mask_ratio, generator=generator)

    def train_step(state: TrainState, view1, view2, edge_map_weight: Union[torch.Tensor, float]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_data_axis()
        m = state.model
        m.train()
        outputs = forward_fn(m, view1, view2 if contrastive else None, state.generator)
        total, metrics = mae_loss_terms(
            outputs, at_least_f32(view1), patch_size,
            edge_map_weight=edge_map_weight, contr_weight=contr_weight,
            perceptual_weight=perceptual_weight, norm_pix_loss=norm_pix_loss,
            filters_dtype=loss_filters_dtype,
        )
        for p in state.tx.params:
            p.grad = None
        total.backward()
        for p in state.tx.params:
            if p.grad is None:  # never used (the projector): a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(p.grad for p in state.tx.params)
        state.tx.step()
        state.step += 1
        return state, metrics

    return train_step


def check_data_axis() -> None:
    """Raise when the ambient mesh has data > 1: the step would neither
    average the gradient nor take the BatchNorm statistics over the data
    group, so the ranks along it would drift apart."""
    mesh = get_mesh()
    if mesh is not None and mesh.size("data") > 1:
        raise ValueError(
            f"make_train_step: the mesh has data={mesh.size('data')}, but the step does not "
            "all-reduce the gradient mean or the contrastive BatchNorm's batch statistics over "
            "the 'data' group; data-parallel training (DDP) is not ported yet. Train on a mesh "
            "of data=1 (the sequence-parallel paths' (1, M)) or without a mesh."
        )


def feature_step(model: VisionTransformer3D, batch: torch.Tensor) -> torch.Tensor:
    """Batched encoder inference: `forward_features` with autograd off."""
    with torch.inference_mode():
        return model.forward_features(batch)
