"""Tensor parallelism over the mesh's 'model' axis, and the placement of a
parameter on a ('data', 'model') mesh.

Counterpart of the JAX package's parallel/tp.py. The rules are JAX's, read
over the JAX paths of the port's parameters (`jax_path` inverts the weight
bridge's map, train/checkpoint.py `_torch_name_and_value`):

- attention qkv kernel (C, 3C): its output dim over 'model' (the heads
  computed locally), and its bias;
- attention proj kernel (C, C): its input dim over 'model' (row-parallel);
- MLP Dense_0 (C, 4C) column-parallel with its bias, Dense_1 (4C, C)
  row-parallel;
- everything else replicated.

A placement is JAX's PartitionSpec as a tuple over the JAX dims (trailing
None dropped); `torch_dims` maps it onto the dims of the port's tensor
(flax kernels are (in, out), `nn.Linear` weights (out, in)).

JAX places the parameters and lets GSPMD insert the collectives; here each
rank holds its block of every sharded leaf (`local_block`) and the trunk
runs Megatron's pair around each parallel pair of Dense layers
(models/vit.py `Attention`, `Mlp`): `copy_to_model` (identity forward, an
all-reduce of the gradient over 'model' backward) on the input of the
column-parallel layer, `reduce_from_model` (an all-reduce over 'model'
forward, identity backward) on the row-parallel layer's partial products,
whose bias is added once, after the sum. Every rank of a 'model' group thus
holds the same replicated parameters and gradients. The qkv's output dim is
cut by heads (rank m holds q, k and v of heads [m H/M, (m + 1) H/M)),
where JAX's contiguous cut mixes q, k and v on one device and GSPMD
reshards them: the placement (which dim, which axis) is JAX's, the order
of the rows within it the heads'.

`shard_train_state(state, mesh)` turns TP on, as JAX's does, and
re-initialises the optimizer from the sharded parameters. It refuses
before any collective what JAX refuses: `attn_impl` 'auto' or
'flash_packed' under a model axis > 1 (the packed kernel's (B, N, 3C)
layout holds whole heads of all three), and a head count that the model
axis does not divide. LayerNorm fusion (`ln_fusion="on"`) falls back to
the unfused pair under TP, as in JAX (kernel #7 holds the whole W).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from vit_ae_plus_plus_torch.parallel.mesh import Mesh, all_gather_dim, all_reduce_sum

Spec = Tuple[Optional[str], ...]  # a PartitionSpec over the JAX dims
_DENSE = {"fc1": "Dense_0", "fc2": "Dense_1"}
# attn_impl values that JAX refuses under a model axis > 1
PACKED_IMPLS = ("auto", "flash_packed")


def _head_path(idx: str, leaf: str) -> Tuple[str, str]:
    """A head's Sequential index and leaf -> flax's (Dense_l | BatchNorm_l,
    kernel | scale | bias): Linear at 3l, BatchNorm at 3l + 1."""
    i = int(idx)
    kind = "Dense" if i % 3 == 0 else "BatchNorm"
    name = ("kernel" if kind == "Dense" else "scale") if leaf == "weight" else leaf
    return f"{kind}_{i // 3}", name


def jax_path(name: str, ndim: int, moco: bool = False) -> Tuple[str, ...]:
    """The JAX path of the port's parameter `name` (of `ndim` dims) in a
    MAE, ViT or MoCo (`moco`) model: the inverse of the weight bridge."""
    parts = name.split(".")
    if moco:
        if parts[0] == "base_encoder" and parts[1] in ("head", "fc"):  # the projector grafted in
            return ("projector", *_head_path(parts[2], parts[3]))
        if parts[0] == "base_encoder":
            return ("trunk", *jax_path(".".join(parts[1:]), ndim))
        if parts[0] == "predictor":
            return ("predictor", *_head_path(parts[1], parts[2]))
    if parts[0] == "patch_embed":  # a Conv3d here, flax's Dense (p^3 C, D) there
        return ("patch_embed", "proj", "kernel" if parts[-1] == "weight" else "bias")
    if parts[0] in ("cls_token", "mask_token", "pos_embed"):
        return (parts[0],)
    if parts[0] in ("predictor", "projection_head"):
        head = "predictor" if parts[0] == "predictor" else "projector"
        return ("heads", head, *_head_path(parts[1], parts[2]))
    if parts[0] in ("blocks", "decoder_blocks"):
        parts = [f"{parts[0]}_{parts[1]}", *parts[2:]]
    parts = [_DENSE.get(p, p) for p in parts]
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim == 2 else "scale"
    return tuple(parts)


def _spec_for_path(path: Sequence[str]) -> Spec:
    """JAX's TP rule (parallel/tp.py:36-50 there), over a JAX path."""
    names = list(path)
    leaf = names[-1]
    if "attn" in names:
        if "qkv" in names:
            return (None, "model") if leaf == "kernel" else ("model",)
        if "proj" in names:
            return ("model", None) if leaf == "kernel" else ()
    if "mlp" in names:
        if "Dense_0" in names:
            return (None, "model") if leaf == "kernel" else ("model",)
        if "Dense_1" in names:
            return ("model", None) if leaf == "kernel" else ()
    return ()


def is_moco(model: nn.Module) -> bool:
    return any(n.startswith("base_encoder.") for n, _ in model.named_parameters())


def jax_shape(path: Sequence[str], shape: Sequence[int]) -> Tuple[int, ...]:
    """The leaf's shape in the JAX layout: a 2-D kernel transposed."""
    return tuple(reversed(shape)) if path[-1] == "kernel" and len(shape) == 2 else tuple(shape)


def torch_dims(path: Sequence[str], ndim: int, spec: Spec) -> Dict[str, int]:
    """{axis: the port tensor's dim} of a placement over the JAX dims."""
    out = {}
    for jdim, axis in enumerate(spec):
        if axis is None:
            continue
        if "patch_embed" in path:
            raise ValueError("the patch embed's Conv3d layout has no sharded placement")
        out[axis] = (ndim - 1 - jdim) if path[-1] == "kernel" and ndim == 2 else jdim
    return out


def _trimmed(spec: Spec) -> Spec:
    """A placement without trailing Nones (P('model', None) is P('model'))."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def tp_param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """{parameter name: JAX's TP placement} over the model's parameters."""
    moco = is_moco(model)
    return {n: _trimmed(_spec_for_path(jax_path(n, p.ndim, moco))) for n, p in model.named_parameters()}


def _by_heads(name: str) -> bool:
    """A leaf whose 'model' cut goes by heads: the qkv projection's rows."""
    return name.endswith(("attn.qkv.weight", "attn.qkv.bias"))


def local_block(name: str, full: torch.Tensor, dims: Dict[str, int], mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole leaf `full` placed on `dims`: its
    head group (qkv) or contiguous block over 'model', then its contiguous
    block over 'data' (JAX's addressable shard on a data mesh)."""
    t = full
    if "model" in dims and mesh.size("model") > 1:
        msize, m, dim = mesh.size("model"), mesh.coords["model"], dims["model"]
        if _by_heads(name):
            t = t.unflatten(dim, (3, msize, -1)).select(dim + 1, m).flatten(dim, dim + 1)
        else:
            t = t.chunk(msize, dim=dim)[m]
    if "data" in dims and mesh.size("data") > 1:
        t = t.chunk(mesh.size("data"), dim=dims["data"])[mesh.coords["data"]]
    return t.contiguous()


def whole(name: str, block: torch.Tensor, dims: Dict[str, int], mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's `local_block`: collective over the
    axes the leaf is sharded on (every rank of them calls it)."""
    t = block
    if "data" in dims:
        t = all_gather_dim(t, mesh, "data", dims["data"])
    if "model" in dims and mesh.size("model") > 1:
        dim = dims["model"]
        if _by_heads(name):
            parts = all_gather_dim(t.unflatten(dim, (3, -1)).unsqueeze(dim + 1), mesh, "model", dim + 1)
            t = parts.flatten(dim, dim + 2)  # (3, M, C / M) back to the rows' (3, H, d) order
        else:
            t = all_gather_dim(t, mesh, "model", dim)
    return t


def _module_of(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    mod, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    return root.get_submodule(mod), leaf


def shard_module(module: nn.Module, placements: Dict[str, Dict[str, int]], mesh: Mesh) -> None:
    """Replace every placed parameter of `module` by this rank's block (a new
    `nn.Parameter`, so an optimizer over the old ones must be rebuilt), turn
    TP on in the attention and MLP modules of a 'model'-placed leaf, and
    mark each unit that gathers its 'data'-placed leaves at its use
    (parallel/fsdp.py). `placements`: {name: {axis: dim}}; the module keeps
    them (`module.placements`) for the layout-independent checkpoints."""
    for name, dims in placements.items():
        if not dims:
            continue
        owner, leaf = _module_of(module, name)
        old = owner._parameters[leaf]
        owner._parameters[leaf] = nn.Parameter(local_block(name, old.detach(), dims, mesh).clone(),
                                               requires_grad=old.requires_grad)
        if "model" in dims and mesh.size("model") > 1:  # the Attention or Mlp that holds it
            module.get_submodule(name.rsplit(".", 2)[0]).tp = True
        if "data" in dims and mesh.size("data") > 1:
            unit, rel = _unit_of(module, name)
            unit.fsdp = {**(getattr(unit, "fsdp", None) or {}), rel: dims["data"]}
    module.placements = {n: dict(d) for n, d in placements.items() if d}


def _unit_of(root: nn.Module, name: str) -> Tuple[nn.Module, str]:
    """The module that gathers a 'data'-placed leaf at its use: the
    innermost enclosing module marked `fsdp_unit` (a transformer block),
    else the leaf's own Linear. -> (unit, the leaf's name within it)."""
    parts = name.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        mod = root.get_submodule(".".join(parts[:cut]))
        if getattr(mod, "fsdp_unit", False):
            return mod, ".".join(parts[cut:])
    owner, leaf = _module_of(root, name)
    if not isinstance(owner, nn.Linear):
        raise NotImplementedError(f"{name}: a sharded leaf outside a block must be a Linear's")
    return owner, leaf


def check_tp(model: nn.Module, mesh: Mesh) -> None:
    """JAX's refusals of a tensor-parallel trunk, before any collective:
    the packed attention and a head count the model axis does not
    divide; and the port's own: the sequence-parallel attention, which
    shards the tokens over the same axis."""
    msize = mesh.size("model")
    impls = {m.attn_impl for m in model.modules() if hasattr(m, "attn_impl")}
    if impls & set(PACKED_IMPLS):
        raise ValueError(
            "attn_impl='auto'/'flash_packed' is not tensor-parallel-safe; build the model with "
            "attn_impl='flash' or 'plain' for a mesh with a model axis > 1")
    for impl in sorted(impls & {"flash_ring", "flash_seq"}):
        raise ValueError(f"attn_impl={impl!r} shards the tokens over 'model', which tensor parallelism "
                         "gives to the heads: pick one of the two")
    for mod in model.modules():
        heads = getattr(mod, "num_heads", None)
        if heads is not None and heads % msize:
            raise ValueError(f"{heads} heads do not split over a model axis of {msize}")


def shard_train_state(state, mesh: Mesh):
    """Tensor-parallel training state (JAX's `shard_train_state`): the TP
    leaves cut over 'model', the rest replicated, the optimizer rebuilt
    over the blocks (its moments created from them, its count at 0).
    Call it right after `create_train_state`, before any step."""
    if mesh.size("model") > 1:
        check_tp(state.model, mesh)
    specs = tp_param_shardings(state.model, mesh)
    moco = is_moco(state.model)
    placements = {n: torch_dims(jax_path(n, p.ndim, moco), p.ndim, specs[n])
                  for n, p in state.model.named_parameters()}
    shard_module(state.model, placements, mesh)
    state.tx = state.tx.rebuild(state.model)
    return state


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; backward, the sum over 'model' of the
    ranks' gradients (each rank's heads or hidden units contribute theirs)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _sum_in_f32(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: forward, the sum over 'model' of the ranks' partial
    products; backward identity (every rank's downstream is the same)."""

    @staticmethod
    def forward(ctx, t, mesh):
        return _sum_in_f32(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sum_in_f32(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over 'model', in at least f32 and rounded back to t's dtype:
    a bf16 row-parallel product sums its ranks' rounded partials."""
    wide = torch.promote_types(t.dtype, torch.float32)
    return all_reduce_sum(t.to(wide), mesh, "model").to(t.dtype)


def copy_to_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _CopyToModel.apply(t, mesh)


def reduce_from_model(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(t, mesh)
