"""The SSL training step and the inference step.

Counterpart of the JAX package's train/step.py: `make_train_step` builds
forward, composite loss, backward, global-norm metric and AdamW update as
one call; `make_eval_step` the reconstruction-loss evaluation;
`feature_step` is batched encoder inference. PyTorch runs
eagerly, so the step is a plain function over a mutable `TrainState`.

The JAX step shards the batch over the mesh's 'data' axis with the state
replicated, so its gradient and the contrastive BatchNorm's statistics are
the global batch's. Under an ambient mesh of (D, 1), each rank passes its
b = B / D rows of the global batch; the BatchNorm takes its moments over
the 'data' group (models/vit.py `FlaxBatchNorm`), the masking noise is the
global batch's (models/mae.py), and after `backward` the gradients are
averaged over the group in one flat all-reduce, before the global norm,
the clip and AdamW, so every rank applies the same update; the metrics are
the group's means. That is the global batch's step because every loss term
is a mean over equally many elements on every rank (train/objective.py
`mae_loss_terms`): the masked reconstruction divides by the rank's masked
patch count, which is b times the same count per volume; the edge term is
a mean over the rank's whole volumes; the contrastive term a mean over its
b (1 + kept) tokens of each view.

On a mesh of (D, M > 1) the batch is sliced over 'data' as above and every
rank of a 'model' group passes its data coordinate's rows: with
'flash_ring' or 'flash_seq' the attention shards the tokens over 'model'
(kernels/ring_flash.py, seq_flash.py) on a replicated trunk; after
`parallel.tp.shard_train_state` the trunk's heads and hidden units are
cut over 'model' (tensor parallelism, models/vit.py), and with 'flash' or
'plain' on an unsharded trunk every model rank repeats its group's work.
Gradients are averaged over 'data' only. As in the JAX package, a mesh
with model > 1 refuses `attn_impl` 'auto' (the packed kernel) before any
forward. After `parallel.fsdp.shard_train_state_fsdp` the state is
sharded over 'data': each sharded leaf's gradient arrives reduce-scattered
(summed over 'data', models/vit.py gathers the leaves at their use) and is
divided by D, the replicated leaves' are all-reduced, and the global norm
and the clip take each leaf whole (train/optim.py).

On a ('data', 'pipe') mesh the forward is the GPipe pipeline's
(parallel/pp.py `make_pp_train_step` passes it as `forward_fn`): each
stage holds its blocks, the gradients are averaged over its 'data' group
as above, and the global norm sums the stages' blocks over 'pipe' and
counts the leaves every stage holds once.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D
from vit_ae_plus_plus_torch.ops import at_least_f32
from vit_ae_plus_plus_torch.parallel import all_reduce_flat, all_reduce_sum, get_mesh
from vit_ae_plus_plus_torch.parallel.mesh import broadcast_from
from vit_ae_plus_plus_torch.parallel.tp import PACKED_IMPLS
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
    perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
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
    `perceptual_fn` with `perceptual_weight` adds the VGG term
    (train/objective.py `mae_loss_terms`, gradient-free). Under
    `make_adamw(accum_iter=k)` each call is one mini-step and `grad_norm`
    is that mini-step's gradient's, as the JAX step reports it under
    optax's `MultiSteps`.

    Under a `parallel.set_mesh` mesh of (D, M) the step is data parallel
    over 'data' and the metrics are the 'data' group's means; under a
    model axis > 1 it raises `ValueError` for `attn_impl` 'auto' (see the
    module's docstring)."""
    contrastive = model.cfg.contrastive

    if forward_fn is None:

        def forward_fn(m, view1, view2, generator):
            return m(view1, view2, mask_ratio=mask_ratio, generator=generator)

    def train_step(state: TrainState, view1, view2, edge_map_weight: Union[torch.Tensor, float]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_mesh(model)
        m = state.model
        m.train()
        outputs = forward_fn(m, view1, view2 if contrastive else None, state.generator)
        total, metrics = mae_loss_terms(
            outputs, at_least_f32(view1), patch_size,
            edge_map_weight=edge_map_weight, contr_weight=contr_weight,
            perceptual_weight=perceptual_weight, norm_pix_loss=norm_pix_loss,
            perceptual_fn=perceptual_fn, filters_dtype=loss_filters_dtype,
        )
        for p in state.tx.params:
            p.grad = None
        total.backward()
        for p in state.tx.params:
            if p.grad is None:  # never used (the projector): a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        metrics = data_mean({k: v.detach() for k, v in metrics.items()})
        average_grads(state.tx.params, state.tx.shard_axes)
        metrics["grad_norm"] = global_norm([p.grad for p in state.tx.params], state.tx.shard_axes)
        state.tx.step()
        state.step += 1
        return state, metrics

    return train_step


def check_mesh(model) -> None:
    """JAX's refusal (train/step.py:58-70 there), before any forward: the
    packed attention ('auto', 'flash_packed') under a model axis > 1."""
    mesh = get_mesh()
    if mesh is not None and mesh.size("model") > 1 and model.cfg.attn_impl in PACKED_IMPLS:
        raise ValueError(
            "attn_impl='auto'/'flash_packed' is not tensor-parallel-safe; build the model with "
            "attn_impl='flash' or 'plain' (or a sequence-parallel 'flash_ring' / 'flash_seq') for a mesh "
            "with a model axis > 1")


def average_grads(params, shard_axes=None) -> None:
    """Replace each parameter's gradient by its mean over the ambient mesh's
    'data' group: a leaf sharded over 'data' (`shard_axes[i]` holds it)
    arrives summed over the group by its gather's backward and is divided
    by D; the others go through one flat all-reduce per dtype (nothing
    without a mesh)."""
    mesh = get_mesh()
    if mesh is None or mesh.size("data") == 1:
        return
    params = list(params)
    size = mesh.size("data")
    sharded = {i for i, a in enumerate(shard_axes or ()) if "data" in a}
    for i in sharded:
        params[i].grad.div_(size)
    whole = [p for i, p in enumerate(params) if i not in sharded]
    for p, g in zip(whole, all_reduce_flat([p.grad for p in whole], mesh, "data")):
        p.grad = g.div_(size)


def agree_over_model(params, shard_axes=None) -> None:
    """Under a mesh whose model axis > 1 only repeats the step (the MoCo and
    contrastive steps: each rank of a 'model' group runs its data
    coordinate's rows through the whole model), give every rank of the
    group its first rank's gradients, one broadcast per dtype, so that
    kernels that sum in no fixed order (cuDNN's convolution weight
    gradients, max-pooling's backward) cannot set the replicas apart; the
    values are the 'data' group's means all the same. Leaves cut over
    'model' (`shard_axes[i]` holds it: TP under FSDP) keep their own."""
    mesh = get_mesh()
    if mesh is None or mesh.size("model") == 1:
        return
    params = list(params)
    axes = list(shard_axes) if shard_axes is not None else [()] * len(params)
    whole = [p for p, a in zip(params, axes) if "model" not in a]
    by_dtype: dict = {}
    for p in whole:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = broadcast_from(torch.cat([p.grad.reshape(-1) for p in group]), mesh, "model", 0)
        for p, part in zip(group, torch.split(flat, [p.grad.numel() for p in group])):
            p.grad = part.view(p.grad.shape)


def data_mean(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The device scalars of `metrics` averaged over the ambient mesh's
    'data' group, in one all-reduce (as they are without one)."""
    mesh = get_mesh()
    if mesh is None or mesh.size("data") == 1:
        return metrics
    names = list(metrics)
    mean = all_reduce_sum(torch.stack([metrics[n] for n in names]), mesh, "data") / mesh.size("data")
    return dict(zip(names, mean.unbind()))


def make_eval_step(
    model,
    patch_size: int,
    *,
    mask_ratio: float = 0.75,
    norm_pix_loss: bool = False,
) -> Callable:
    """Build `eval_step(model, view1, generator=None, noise=None) -> metrics`:
    the reconstruction loss terms of one view without gradients, the
    contrastive heads' BatchNorm on its running statistics. The masking
    noise is `noise` when given, else drawn from `generator`."""

    def eval_step(m, view1, generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        was_training = m.training
        m.eval()
        try:
            with torch.no_grad():
                outputs = m(view1, None, mask_ratio=mask_ratio, noise=noise, generator=generator)
                _, metrics = mae_loss_terms(outputs, at_least_f32(view1), patch_size,
                                            norm_pix_loss=norm_pix_loss)
        finally:
            m.train(was_training)
        return metrics

    return eval_step


def feature_step(model: VisionTransformer3D, batch: torch.Tensor) -> torch.Tensor:
    """Batched encoder inference: `forward_features` with autograd off."""
    with torch.inference_mode():
        return model.forward_features(batch)
