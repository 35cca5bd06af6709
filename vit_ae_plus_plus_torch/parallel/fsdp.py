"""FSDP (ZeRO-3-style) sharding of the parameters, their gradients and the
optimizer state over the mesh's 'data' axis.

Counterpart of the JAX package's parallel/fsdp.py, with its rule kept
exactly (`_fsdp_spec`): a leaf of at least `_MIN_SHARD_ELEMENTS` elements,
outside `_REPLICATED_PATHS`, has 'data' on its largest dimension, in JAX
dimension order, that tensor parallelism leaves free and that the data size
divides (the first such dimension on a tie); every other leaf is
replicated. The dimension is chosen on the JAX layout and mapped onto the
port's tensor (parallel/tp.py `torch_dims`), so a square (768, 768)
kernel shards its input dimension, as JAX's does.

JAX commits the leaves to their shards and GSPMD gathers them around their
uses. Here each rank stores only its 1/D block of every sharded leaf
(`shard_train_state_fsdp` replaces the parameters and rebuilds the
optimizer from the blocks, so the AdamW moments, the LARS traces and
`MultiSteps`' running mean are created from them and never held whole),
and a unit gathers its leaves at its use (`gathered_call`): a transformer
block (`fsdp_unit`) or a Linear outside the blocks (the decoder embed, the
heads). Inside a unit the gathered leaves stand in for the blocks
(`torch.nn.utils.stateless._reparametrize_module`) and are freed when the
unit returns; the unit runs under `torch.utils.checkpoint`, so the
backward gathers them again, recomputes the unit's forward, and the
gathers' backward reduce-scatters each leaf's gradient back to this
rank's block, summed over 'data' (the step divides by D). A rank's peak
thus holds one unit's gathered leaves beside its blocks, at the cost of a
second forward of every unit. Replicated leaves keep the data-parallel
all-reduce (train/step.py `average_grads`).

Checkpoints stay layout-independent (`full_state_dict`,
`full_optimizer_state`, and their loaders, which cut full leaves back into
this rank's blocks): every rank takes part in each gather, which is a
collective, and the writer rank writes the reference layout.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint as ckpt
from torch import nn
from torch.nn.utils.stateless import _reparametrize_module

from vit_ae_plus_plus_torch.parallel.mesh import Mesh, gather_shards, get_mesh
from vit_ae_plus_plus_torch.parallel.tp import (
    Spec,
    check_tp,
    is_moco,
    jax_path,
    jax_shape,
    local_block,
    shard_module,
    torch_dims,
    tp_param_shardings,
    whole,
)

# below this many elements a leaf is replicated (norm scales, biases, tokens)
_MIN_SHARD_ELEMENTS = 8192

# leaves whose JAX path holds any of these stay replicated: they sit against
# the patchify / unpatchify reshapes (JAX parallel/fsdp.py:17-24 there)
_REPLICATED_PATHS = ("patch_embed", "decoder_pred", "pos_embed")


def _fsdp_spec(base: Spec, shape: Tuple[int, ...], data: int, min_size: int = _MIN_SHARD_ELEMENTS) -> Spec:
    """Extend `base` (the TP placement, possibly ()) with 'data' on the
    largest free divisible dimension of `shape` (JAX layout); `base`
    unchanged if none qualifies."""
    if int(np.prod(shape)) < min_size:
        return base
    spec = list(base) + [None] * (len(shape) - len(base))
    free = [d for d in range(len(shape)) if spec[d] is None and shape[d] % data == 0 and shape[d] >= data]
    if not free:
        return base
    d = max(free, key=lambda i: shape[i])
    spec[d] = "data"
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def fsdp_param_shardings(model: nn.Module, mesh: Mesh, min_size: Optional[int] = None) -> Dict[str, Spec]:
    """{parameter name: placement over the JAX dims}: the TP rules when the
    mesh has a model axis > 1, plus 'data' on every large leaf (at least
    `min_size` elements, `_MIN_SHARD_ELEMENTS` by default)."""
    min_size = _MIN_SHARD_ELEMENTS if min_size is None else min_size
    data = mesh.size("data")
    tp = tp_param_shardings(model, mesh) if mesh.size("model") > 1 else {}
    moco = is_moco(model)
    out = {}
    for name, p in model.named_parameters():
        path = jax_path(name, p.ndim, moco)
        base = tp.get(name, ())
        if any(n in path for n in _REPLICATED_PATHS):
            out[name] = base
        else:
            out[name] = _fsdp_spec(base, jax_shape(path, p.shape), data, min_size)
    return out


def _placements(model: nn.Module, specs: Dict[str, Spec]) -> Dict[str, Dict[str, int]]:
    moco = is_moco(model)
    return {n: torch_dims(jax_path(n, p.ndim, moco), p.ndim, specs[n]) for n, p in model.named_parameters()}


def _check_mesh(model: nn.Module, mesh: Mesh) -> None:
    if mesh is None or mesh.size("data") <= 1:
        raise ValueError("--fsdp needs a data mesh (--n-devices > 1)")
    if mesh.size("model") > 1:
        check_tp(model, mesh)


def shard_train_state_fsdp(state, mesh: Mesh, min_size: Optional[int] = None):
    """Shard a fresh `TrainState` over 'data' (and its TP leaves over 'model'
    on a model axis > 1): each rank keeps its blocks, and the optimizer is
    rebuilt from them (its moments created in the sharded layout, its count
    at 0). Call it right after `create_train_state`, before any step.
    -> (state, {name: placement}) as JAX's returns the state and its
    shardings."""
    _check_mesh(state.model, mesh)
    specs = fsdp_param_shardings(state.model, mesh, min_size)
    shard_module(state.model, _placements(state.model, specs), mesh)
    state.tx = state.tx.rebuild(state.model)
    return state, specs


def shard_moco_state_fsdp(state, mesh: Mesh, min_size: Optional[int] = None):
    """The MoCo state's variant: the base and the momentum encoders take the
    same placement (the EMA is elementwise, so the momentum leaves stay
    sharded through the step), the LARS traces are created from the base
    blocks, and the BatchNorm statistics stay replicated. -> (state,
    {name: placement})."""
    _check_mesh(state.model, mesh)
    specs = fsdp_param_shardings(state.model, mesh, min_size)
    placements = _placements(state.model, specs)
    shard_module(state.model, placements, mesh)
    prefix = "base_encoder."
    shard_module(state.momentum_encoder,
                 {n[len(prefix):]: d for n, d in placements.items() if n.startswith(prefix)}, mesh)
    state.tx = state.tx.rebuild(state.model)
    return state, specs


def gathered_call(unit: nn.Module, fn, *args):
    """`fn(*args)` with the unit's 'data'-sharded leaves (`unit.fsdp`: {name
    within the unit: dim}) gathered whole for the call; under autograd the
    unit is checkpointed, so its backward gathers them again and
    reduce-scatters their gradients (module docstring)."""
    mesh = get_mesh()
    if mesh is None or mesh.size("data") == 1:
        raise RuntimeError("this module's parameters are sharded over 'data': run it under its mesh "
                           "(parallel.set_mesh)")

    def run(*inner):
        full = {n: gather_shards(unit.get_parameter(n), mesh, "data", dim) for n, dim in unit.fsdp.items()}
        with _reparametrize_module(unit, full):
            return fn(*inner)

    if torch.is_grad_enabled() and any(p.requires_grad for p in unit.parameters()):
        return ckpt.checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    return run(*args)


def full_state_dict(module: nn.Module, state_dict: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The module's state dict (or `state_dict`, one of its earlier copies)
    with every sharded leaf whole, detached, on its device: collective over
    the sharded axes, so every rank calls it."""
    placements = getattr(module, "placements", {})
    mesh = get_mesh()
    sd = module.state_dict() if state_dict is None else state_dict
    return {n: (whole(n, v, placements[n], mesh) if n in placements else v).detach() for n, v in sd.items()}


def load_full_state_dict(module: nn.Module, state_dict: Dict[str, torch.Tensor], strict: bool = True) -> None:
    """Load whole leaves (a reference-layout state dict) into a sharded
    module: each placed leaf cut to this rank's block first."""
    placements = getattr(module, "placements", {})
    mesh = get_mesh()
    module.load_state_dict({n: local_block(n, v, placements[n], mesh) if n in placements else v
                            for n, v in state_dict.items()}, strict=strict)


def _map_optimizer_state(tx, opt_state: Dict, fn) -> Dict:
    """`opt_state` (`tx.opt.state_dict()`-shaped) with every per-parameter
    tensor of a placed parameter passed through fn(name, tensor, dims)."""
    placements = getattr(tx, "placements", {})
    names = {id(p): n for n, p in zip(tx.names, tx.params)}
    flat = [names[id(p)] for g in tx.opt.param_groups for p in g["params"]]
    state = dict(opt_state["state"])
    for i, name in enumerate(flat):
        if name in placements and i in state:
            state[i] = {k: fn(name, v, placements[name]) if torch.is_tensor(v) and v.ndim > 0 else v
                        for k, v in state[i].items()}
    return {**opt_state, "state": state}


def full_optimizer_state(tx) -> Dict:
    """`tx.opt.state_dict()` with the moments (or traces) of sharded leaves
    whole: collective."""
    mesh = get_mesh()
    return _map_optimizer_state(tx, tx.opt.state_dict(), lambda n, v, dims: whole(n, v, dims, mesh).detach())


def local_optimizer_state(tx, opt_state: Dict) -> Dict:
    """A `full_optimizer_state` cut to this rank's blocks."""
    mesh = get_mesh()
    return _map_optimizer_state(tx, opt_state, lambda n, v, dims: local_block(n, v, dims, mesh))


def full_like_params(tx, tensors) -> list:
    """Tensors shaped as `tx.params` (`MultiSteps`' running mean), each of a
    sharded leaf whole: collective."""
    placements, mesh = getattr(tx, "placements", {}), get_mesh()
    return [whole(n, t, placements[n], mesh).detach() if n in placements else t for n, t in zip(tx.names, tensors)]


def local_like_params(tx, tensors) -> list:
    """Whole tensors shaped as `tx`'s leaves, cut to this rank's blocks."""
    placements, mesh = getattr(tx, "placements", {}), get_mesh()
    return [local_block(n, t, placements[n], mesh) if n in placements else t for n, t in zip(tx.names, tensors)]
