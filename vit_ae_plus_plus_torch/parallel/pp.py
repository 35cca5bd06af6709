"""GPipe pipeline parallelism of the ViT and MAE block stacks over a 'pipe'
mesh axis.

Counterpart of the JAX package's parallel/pp.py, function by function.
JAX runs the pipeline as one SPMD program: the blocks' parameters stacked
to (L, ...) leaves sharded over 'pipe', a `shard_map` scanning M + S - 1
ticks, `ppermute` handing each activation to the next stage, the finished
microbatches rebroadcast by a masked `psum`, and the backward pipeline
falling out of AD. Here every rank of a ('data', 'pipe') mesh
(`make_pipeline_mesh`, rank d * S + p at (d, p)) runs its own program:

- a stage owns its blocks, [p L / S, (p + 1) L / S) of `blocks` and of
  `decoder_blocks` (`shard_pipeline_state`); the others' places in the
  `nn.ModuleList` hold a `RemoteBlock`, so parameter names, checkpoints and
  the weight bridge keep the per-layer layout, and a stage's parameters,
  gradients and AdamW moments are its blocks' (1/S of the stacks) and the
  leaves outside the stacks, which every stage holds and computes;
- `pipeline_blocks` runs the GPipe schedule: stage p applies its blocks to
  M microbatches in turn, receiving each from p - 1 and sending the result
  to p + 1 (`parallel.mesh.send_to` / `recv_from`, through pinned host
  memory on gloo); the last stage's finished microbatches go to every
  stage (`from_last`, JAX's masked psum). The backward (`_GPipe.backward`)
  takes the last stage's output gradient once, runs the microbatches back
  in the reverse order, each stage receiving from p + 1 and sending to
  p - 1, and the input's gradient, which only stage 0 has, reaches every
  stage (`from_first`, the transpose of JAX's `where(idx == 0, ...)`). So
  the leaves before a stack (the patch embed, `cls_token`, `pos_embed`;
  `decoder_embed`, `mask_token`) take stage 0's gradient on every stage,
  the leaves after it (`norm`, `decoder_norm`, `decoder_pred`, the heads)
  the gradient each stage computes on the same values, and every stage
  applies the same update to them. JAX also computes the warm-up
  bubble's garbage; the results here are the same without it.
- a stage's attention is `make_block_apply`'s: 'flash_local' (the per-head
  kernels, kernels #3 and #4, whatever the mesh) on CUDA tensors and
  'plain' on the CPU, as JAX forces `flash_local` on the TPU and 'xla'
  elsewhere;
- with `data_axis` (FSDP composed with the pipe, JAX
  `pp_state_shardings(data_axis=...)`), a block leaf of at least 2**15
  elements (per layer) also keeps only its block of its largest
  divisible dimension over 'data', and its `Block` gathers it at its use
  (parallel/fsdp.py `gathered_call`). This rule, its floor and its order
  of dimensions are pp.py's, not fsdp.py's.

`pipelined_forward_features`, `pipelined_mae_forward` (contrastive: the
encoder stack at 2M microbatches, the heads and their BatchNorm after the
decoder pipeline) and `make_pp_train_step` (through train/step.py
`make_train_step(forward_fn=...)`, as JAX's, so the two steps cannot
drift) run the models' own forwards with each block stack replaced by the
pipeline. In the step, the gradients of the leaves a stage does not share
are summed over 'pipe' only where a norm needs them (the clip's
`global_norm`: train/optim.py, each stage's blocks and the shared leaves
once), and averaged over the stage's 'data' group (train/step.py
`average_grads`).

Checkpoints stay per-layer: `full_state_dict` gathers every stage's blocks
(and, under FSDP, their blocks over 'data') into the reference layout; a
pipelined run's resume files are per stage (pipelines/pretrain_kfold.py).
The pipeline refuses tensor parallelism and the sequence-parallel
attention (a pipeline mesh has no 'model' axis, as JAX's has none).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from vit_ae_plus_plus_torch.parallel import fsdp
from vit_ae_plus_plus_torch.parallel.mesh import (
    Mesh,
    all_gather_dim,
    from_first,
    from_last,
    get_mesh,
    make_pipeline_mesh,
    recv_from,
    send_to,
)
from vit_ae_plus_plus_torch.parallel.tp import Spec, jax_path, jax_shape, shard_module, torch_dims

# the block stacks: the port's ModuleList -> JAX to_pp_params' stacked subtree
STACKS = {"blocks": "enc_stack", "decoder_blocks": "dec_stack"}
# below this many elements per layer a block leaf stays data-replicated (JAX pp.py's min_size)
MIN_SHARD_ELEMENTS = 2**15

__all__ = [
    "MIN_SHARD_ELEMENTS",
    "RemoteBlock",
    "auto_microbatches",
    "full_state_dict",
    "make_block_apply",
    "make_pipeline_mesh",
    "make_pp_train_step",
    "pipeline_blocks",
    "pipelined_forward_features",
    "pipelined_mae_forward",
    "pp_param_shardings",
    "shard_pipeline_state",
    "stage_range",
]


def auto_microbatches(batch: int, n_stages: int, data: int = 1) -> int:
    """Largest divisor of `batch` <= 4 * n_stages — the GPipe guidance
    (bubble fraction (S-1)/(M+S-1)) capped by batch divisibility, preferring
    microbatches whose batch dim still splits evenly over the `data` axis
    (JAX pp.py:167-178, unchanged)."""
    best_any = None
    for m in range(min(batch, 4 * n_stages), 0, -1):
        if batch % m == 0:
            best_any = best_any or m
            if (batch // m) % data == 0:
                return m
    return best_any or 1


def stage_range(depth: int, mesh: Optional[Mesh], axis: str = "pipe") -> range:
    """The block indices stage `mesh.coords[axis]` owns: [p L / S, (p + 1)
    L / S); every block without a mesh or on one stage. Raises JAX's error
    for a depth the stages do not divide."""
    stages = mesh.size(axis) if mesh is not None else 1
    if depth % stages:
        raise ValueError(f"depth {depth} not divisible by {stages} pipeline stages")
    per = depth // stages
    p = mesh.coords.get(axis, 0) if mesh is not None else 0
    return range(p * per, (p + 1) * per)


class RemoteBlock(nn.Module):
    """The place of a block that another pipeline stage owns: no
    parameters, and a forward that refuses (the model runs through this
    module's pipelined forwards)."""

    def __init__(self, index: int, stage: int):
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"block {self.index} lives on pipeline stage {self.stage}: run the model through "
                           "parallel.pp (pipelined_mae_forward, pipelined_forward_features)")


def _stack_of(name: str) -> Optional[str]:
    return STACKS.get(name.split(".", 1)[0])


def _pp_spec(shape, data: Optional[int], min_size: int) -> Spec:
    """JAX `pp_state_shardings`' rule (pp.py:134-150) over a stacked leaf's
    shape (L, ...): 'pipe' on the stack dim; with `data`, 'data' on the
    largest non-stack dim that `data` divides (the first on a tie), when
    the leaf holds at least `min_size` elements per layer."""
    parts = ["pipe"] + [None] * (len(shape) - 1)
    if data is not None and len(shape) >= 2 and int(np.prod(shape[1:])) >= min_size:
        for d in sorted(range(1, len(shape)), key=lambda d: -shape[d]):
            if shape[d] % data == 0:
                parts[d] = "data"
                break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def pp_param_shardings(model: nn.Module, mesh: Mesh, data_axis: Optional[str] = None,
                       min_size: int = MIN_SHARD_ELEMENTS) -> Dict[str, Spec]:
    """{parameter name: JAX's placement of its leaf in the stacked state}:
    a block leaf's over the dims of its (L, ...) stack (`_pp_spec`), every
    other leaf's () (replicated). The AdamW moments follow their
    parameters, as JAX's mirror them."""
    data = mesh.size(data_axis) if data_axis is not None else None
    out = {}
    for name, p in model.named_parameters():
        stack = _stack_of(name)
        if stack is None:
            out[name] = ()
            continue
        depth = len(getattr(model, name.split(".", 1)[0]))
        out[name] = _pp_spec((depth, *jax_shape(jax_path(name, p.ndim), p.shape)), data, min_size)
    return out


def check_pipeline(model: nn.Module, mesh: Mesh, data_axis: Optional[str] = None) -> None:
    """The refusals of a pipelined state, before any collective: a depth
    the stages do not divide (JAX's error), FSDP without a data axis > 1
    (JAX pretrain_kfold.py:508-517), and what a pipeline mesh cannot run:
    tensor parallelism and the sequence-parallel attention, which shard
    over a 'model' axis (JAX's pipeline mesh has none)."""
    if mesh is None or mesh.size("pipe") <= 1:
        raise ValueError("a pipelined state needs a mesh with a 'pipe' axis > 1 (make_pipeline_mesh)")
    if mesh.size("model") > 1 or any(getattr(m, "tp", False) for m in model.modules()):
        raise ValueError("tensor parallelism does not compose with the GPipe pipeline: a pipeline mesh is "
                         "('data', 'pipe'), with no 'model' axis, as in the JAX package")
    impls = {m.attn_impl for m in model.modules() if hasattr(m, "attn_impl")}
    for impl in sorted(impls & {"flash_ring", "flash_seq"}):
        raise ValueError(f"attn_impl={impl!r} shards the tokens over a 'model' axis, which a pipeline mesh "
                         "does not have: the stages run 'flash_local' (build the model with 'auto' or 'flash')")
    if data_axis is not None and mesh.size(data_axis) <= 1:
        raise ValueError(f"--fsdp with --pipe-devices needs a data axis > 1 (got data={mesh.size('data')}, "
                         f"pipe={mesh.size('pipe')})")
    for stack in STACKS:
        if hasattr(model, stack):
            stage_range(len(getattr(model, stack)), mesh)


def shard_pipeline_state(state, mesh: Mesh, data_axis: Optional[str] = None,
                         min_size: int = MIN_SHARD_ELEMENTS):
    """The stage layout of a fresh `TrainState` (JAX `to_pp_params` +
    `shard_pp_state`): this stage keeps its blocks of each stack, the
    others become `RemoteBlock`s; with `data_axis` its large block leaves
    keep their 'data' blocks (module docstring); the optimizer is rebuilt
    over what the stage holds (its moments created in that layout, its
    count at 0). Call it right after `create_train_state`, before any
    step. -> (state, {name: placement}) as `pp_param_shardings` gives it."""
    model = state.model
    check_pipeline(model, mesh, data_axis)
    specs = pp_param_shardings(model, mesh, data_axis, min_size)
    stages = mesh.size("pipe")
    for stack in STACKS:
        blocks = getattr(model, stack, None)
        if blocks is None:
            continue
        mine, per = stage_range(len(blocks), mesh), len(blocks) // stages
        for i in range(len(blocks)):
            if i not in mine:
                blocks[i] = RemoteBlock(i, i // per)
    placements = {}
    for name, p in model.named_parameters():
        if specs[name]:
            dims = torch_dims(jax_path(name, p.ndim), p.ndim, specs[name][1:])
            placements[name] = {**dims, "pipe": None}  # held whole by one stage
    shard_module(model, placements, mesh)
    model.pipe_stages = stages
    state.tx = state.tx.rebuild(model)
    return state, specs


def make_block_apply() -> Callable[[nn.Module, torch.Tensor], torch.Tensor]:
    """apply(block, x): one block of a stage, its attention forced to a
    local op (JAX pp.py:181-206): 'flash_local' on CUDA tensors (kernels #3
    and #4), 'plain' on the CPU; a block built 'plain' or 'flash_local'
    keeps its own."""

    def apply(blk: nn.Module, x: torch.Tensor) -> torch.Tensor:
        own = blk.attn.attn_impl
        impl = own if own in ("plain", "flash_local") else ("flash_local" if x.is_cuda else "plain")
        return blk(x, attn_impl=impl)

    return apply


class _GPipe(torch.autograd.Function):
    """This stage's part of the GPipe schedule over `m` microbatches of x
    (module docstring). Forward: the last stage's finished microbatches
    (another stage returns zeros of x's shape, which `from_last`
    replaces); each microbatch's graph through the stage's blocks is kept
    for the backward. Backward: the output gradient read on the last stage
    only, the microbatches back in reverse order, the blocks' gradients
    accumulated into their `.grad`; -> x's gradient on stage 0."""

    @staticmethod
    def forward(ctx, x, stage, mesh, axis, m, grad):
        stages, p = mesh.size(axis), mesh.coords[axis]
        chunks = x.detach().chunk(m)
        saved, outs, sent = [], [], []
        for j in range(m):
            inp = chunks[j] if p == 0 else recv_from(chunks[0], mesh, axis, p - 1, tag=j)
            if grad:
                inp = inp.detach().requires_grad_()
            with torch.set_grad_enabled(grad):
                y = stage(inp)
            if p < stages - 1:
                sent.append(send_to(y.detach(), mesh, axis, p + 1, tag=j))
            else:
                outs.append(y.detach())
            saved.append((inp, y) if grad else None)
        for s in sent:
            s.wait()
        ctx.mesh, ctx.axis, ctx.m, ctx.saved = mesh, axis, m, saved
        return torch.cat(outs) if outs else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, m = ctx.mesh, ctx.axis, ctx.m
        stages, p = mesh.size(axis), mesh.coords[axis]
        out_grads = grad.chunk(m) if p == stages - 1 else None
        dx, sent = [None] * m, []
        for j in reversed(range(m)):  # GPipe's cool-down order
            inp, y = ctx.saved[j]
            ctx.saved[j] = None
            gy = out_grads[j] if out_grads is not None else recv_from(y, mesh, axis, p + 1, tag=j)
            torch.autograd.backward(y, gy)
            if p > 0:
                sent.append(send_to(inp.grad, mesh, axis, p - 1, tag=j))
            else:
                dx[j] = inp.grad
        for s in sent:
            s.wait()
        ctx.saved = None
        return (torch.cat(dx) if p == 0 else None), None, None, None, None, None


def pipeline_blocks(block_apply, blocks: nn.ModuleList, x: torch.Tensor, mesh: Optional[Mesh], *,
                    n_microbatches: int, axis: str = "pipe") -> torch.Tensor:
    """Apply the `len(blocks)` blocks to x (B, N, C), pipelined over
    mesh[axis] stages with GPipe microbatching; every stage passes the same
    x and gets the same output, with gradients as the sequential loop's.
    Without a mesh, or on one stage, the blocks in turn (JAX's fallback).
    Raises JAX's errors for a depth or a batch that does not divide."""
    if mesh is None or mesh.size(axis) == 1:
        for blk in blocks:
            x = block_apply(blk, x)
        return x
    stages, m = mesh.size(axis), n_microbatches
    mine = [blocks[i] for i in stage_range(len(blocks), mesh, axis)]
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by {m} microbatches")
    if any(isinstance(b, RemoteBlock) for b in mine):
        raise RuntimeError(f"stage {mesh.coords[axis]} of {stages} does not hold its blocks: the state was laid out "
                           "for another pipeline mesh")

    def stage(t):
        for blk in mine:
            t = block_apply(blk, t)
        return t

    grad = torch.is_grad_enabled()
    if grad and not x.requires_grad:  # the blocks' parameters still want their gradients
        x = x.detach().requires_grad_()
    y = _GPipe.apply(from_first(x, mesh, axis), stage, mesh, axis, m, grad)
    return from_last(y, mesh, axis)


def pipelined_forward_features(model, x: torch.Tensor, mesh: Optional[Mesh], *, n_microbatches: int,
                               axis: str = "pipe") -> torch.Tensor:
    """`VisionTransformer3D.forward_features` with the block stack pipelined
    (JAX pp.py:295-340): the same features, the patch embed, tokens, final
    norm and pooling on every stage."""
    apply = make_block_apply()
    return model.forward_features(x, blocks_fn=lambda blocks, h: pipeline_blocks(
        apply, blocks, h, mesh, n_microbatches=n_microbatches, axis=axis))


def pipelined_mae_forward(model, view1: torch.Tensor, view2: Optional[torch.Tensor] = None, *,
                          mesh: Optional[Mesh], n_microbatches: int, mask_ratio: float = 0.75,
                          noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                          axis: str = "pipe") -> Dict[str, torch.Tensor]:
    """The MAE forward (models/mae.py) with both block stacks pipelined over
    mesh[axis] (JAX pp.py:343-505): the encoder at `n_microbatches` (twice
    that for the contrastive model's 2B rows of both views), the decoder at
    `n_microbatches`; the masking, the decoder embed and the heads (their
    BatchNorm statistics moving as the model's) on every stage. The mask
    noise is `noise`, else drawn from `generator` as the model draws it.
    -> the model's outputs dict."""
    contrastive = model.cfg.contrastive and view2 is not None
    apply = make_block_apply()

    def blocks_fn(blocks, h):
        m = n_microbatches * (2 if contrastive and blocks is model.blocks else 1)
        return pipeline_blocks(apply, blocks, h, mesh, n_microbatches=m, axis=axis)

    return model(view1, view2, mask_ratio=mask_ratio, noise=noise, generator=generator, blocks_fn=blocks_fn)


def make_pp_train_step(model, patch_size: int, mesh: Mesh, *, n_microbatches: int, mask_ratio: float = 0.75,
                       contr_weight: float = 0.0, perceptual_weight: float = 0.0, norm_pix_loss: bool = False,
                       perceptual_fn=None, loss_filters_dtype: str = "float32", axis: str = "pipe") -> Callable:
    """train/step.py `make_train_step` with the MAE forward pipelined over
    mesh[axis] (JAX pp.py:508-576): the same `(state, view1, view2,
    edge_map_weight) -> (state, metrics)` contract, data parallel over each
    stage's 'data' group. The state must be in the stage layout
    (`shard_pipeline_state`, JAX's `stacked_state=True`): a stage updates
    only the blocks it holds."""
    from vit_ae_plus_plus_torch.train.step import make_train_step

    if mesh is not None and mesh.size(axis) > 1 and getattr(model, "pipe_stages", 1) != mesh.size(axis):
        raise ValueError(f"make_pp_train_step on {mesh.size(axis)} stages needs the stage layout: "
                         "shard_pipeline_state(state, mesh) first")
    contrastive = model.cfg.contrastive

    def forward_fn(m, view1, view2, generator):
        return pipelined_mae_forward(m, view1, view2 if contrastive else None, mesh=mesh,
                                     n_microbatches=n_microbatches, mask_ratio=mask_ratio, generator=generator,
                                     axis=axis)

    return make_train_step(model, patch_size, mask_ratio=mask_ratio, contr_weight=contr_weight,
                           perceptual_weight=perceptual_weight, norm_pix_loss=norm_pix_loss,
                           perceptual_fn=perceptual_fn, loss_filters_dtype=loss_filters_dtype,
                           forward_fn=forward_fn)


def full_state_dict(model: nn.Module, state_dict: Dict[str, torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The model's state dict (or `state_dict`, one of its earlier copies)
    whole and per-layer, in the reference layout: the 'data' blocks
    gathered (parallel/fsdp.py `full_state_dict`), then every stage's
    blocks of each stack gathered over 'pipe' (JAX `_host_params` with
    `from_pp_params`). Collective over the mesh: every rank calls it and
    gets the whole dict."""
    sd = fsdp.full_state_dict(model, state_dict)
    stages = getattr(model, "pipe_stages", 1)
    if stages == 1:
        return sd
    mesh = get_mesh()
    gathered = {stack: _gather_stack(model, sd, stack, mesh) for stack in STACKS if hasattr(model, stack)}
    out, done = {}, set()
    for name, value in sd.items():
        stack = name.split(".", 1)[0]
        if stack not in gathered:
            out[name] = value
        elif stack not in done:  # the stack's whole, in layer order, where its first block stood
            out.update(gathered[stack])
            done.add(stack)
    return out


def _gather_stack(model: nn.Module, sd: Dict[str, torch.Tensor], stack: str, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Every stage's entries of `sd` under `stack.{i}.` -> {name: tensor}
    in layer order: one all-gather over 'pipe' per dtype of the stage's
    entries flattened (every stage holds the same leaves of as many
    blocks)."""
    depth, stages = len(getattr(model, stack)), mesh.size("pipe")
    mine, per = stage_range(depth, mesh), depth // stages
    local = [(int(n.split(".")[1]) - mine.start, n.split(".", 2)[2], v) for n, v in sd.items()
             if n.startswith(f"{stack}.")]
    out: Dict[str, torch.Tensor] = {}
    for dtype in sorted({v.dtype for _, _, v in local}, key=str):
        part = [(j, rest, v) for j, rest, v in local if v.dtype == dtype]
        flat = torch.cat([v.reshape(-1) for _, _, v in part])
        whole = all_gather_dim(flat, mesh, "pipe", 0).view(stages, -1)
        for q in range(stages):
            for (j, rest, v), piece in zip(part, torch.split(whole[q], [v.numel() for _, _, v in part])):
                out[f"{stack}.{q * per + j}.{rest}"] = piece.view(v.shape).clone()
    order = sorted(out, key=lambda n: int(n.split(".")[1]))  # layer order, each block's leaves in their order
    return {n: out[n] for n in order}


def same_on_stages(value: int, mesh: Optional[Mesh]) -> bool:
    """Whether every stage of this rank's 'pipe' line holds the same int
    (collective over 'pipe')."""
    if mesh is None or mesh.size("pipe") == 1:
        return True
    got = all_gather_dim(torch.tensor([value], dtype=torch.int64), mesh, "pipe", 0)
    return bool((got == got[0]).all())
