"""The ('data', 'model') mesh of a torch.distributed world and its transport.

Counterpart of the JAX package's parallel/mesh.py (`make_mesh`) and of
`jax.set_mesh` / `get_abstract_mesh`. JAX runs one program over a mesh of
devices; here every rank of an initialised `torch.distributed` world is one
position of the mesh, rank = d * model + m, and runs its own program:

- `make_mesh(data, model)` builds the process groups of both axes (every
  rank of the world must call it, as `torch.distributed.new_group` asks)
  and returns this rank's `Mesh`: the groups, the axes' sizes and its
  coordinates.
- `set_mesh(mesh)` makes it the ambient mesh of a `with` block, as
  `jax.set_mesh` does; `get_mesh()` reads it (None outside). The
  sequence-parallel attention ('flash_ring', 'flash_seq') reads it.
- The data axis only names the groups: slicing the batch over it is the
  caller's work. The attention paths shard over the 'model' group.

Transport (`ring_shift`, `all_gather_rows`, `all_reduce_sum`) follows the
group's backend. An NCCL group moves CUDA tensors itself. A gloo group moves
host memory, so CUDA tensors go through pinned host buffers once the current
stream has finished producing them, and come back to the card after. That
is how several ranks share one GPU (NCCL refuses two ranks on one device).
Either way the compute stays on the card.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

_AXES = ("data", "model")
_current: contextvars.ContextVar = contextvars.ContextVar("vit_ae_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) grid of ranks: the axes' sizes,
    its coordinates, and for each axis the global ranks along it and their
    process group."""

    shape: dict  # {"data": D, "model": M}
    coords: dict  # {"data": d, "model": m}
    ranks: dict  # axis -> global ranks along it through this rank, by coordinate
    groups: dict  # axis -> its ProcessGroup (None for a one-rank axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]


def make_mesh(data: int, model: int = 1) -> Optional[Mesh]:
    """The ('data', 'model') mesh over the first data * model ranks of the
    initialised default group, global rank d * model + m at (d, m). Every
    rank of the world calls it; a rank outside the mesh gets None. As in
    the JAX package, a mesh smaller than the world warns."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the world has {world}")
    if data * model < world:
        warnings.warn(f"mesh {data}x{model} uses only {data * model} of {world} ranks", stacklevel=2)
    ranks = list(range(data * model))
    grid = [ranks[d * model:(d + 1) * model] for d in range(data)]
    lines = {"model": grid, "data": [list(col) for col in zip(*grid)]}
    me = dist.get_rank()
    mine, groups = {}, {}
    for axis in _AXES:
        for line in lines[axis]:
            # new_group is collective over the world: every rank creates every group
            group = dist.new_group(line) if len(line) > 1 else None
            if me in line:
                mine[axis], groups[axis] = line, group
    if me not in ranks:
        return None
    return Mesh(
        shape={"data": data, "model": model},
        coords={"data": me // model, "model": me % model},
        ranks=mine, groups=groups,
    )


def padded_len(n: int, shards: int) -> int:
    """`n` rounded up to a multiple of 8 * shards: the token count that
    the sequence-parallel attention paths pad to and shard."""
    step = 8 * shards
    return -(-n // step) * step


def local_rows(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """This rank's block of rows of `t` (B, H, N, D): the token axis
    zero-padded to `padded_len` and cut into one block per rank of `axis`."""
    shards = mesh.size(axis)
    pn = padded_len(t.shape[2], shards)
    rows, m = pn // shards, mesh.coords[axis]
    return torch.nn.functional.pad(t, (0, 0, 0, pn - t.shape[2]))[:, :, m * rows:(m + 1) * rows].contiguous()


def get_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `set_mesh` block, or None."""
    return _current.get()


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make `mesh` the ambient mesh inside the block (`jax.set_mesh`)."""
    token = _current.set(mesh)
    try:
        yield mesh
    finally:
        _current.reset(token)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` must travel through host memory: a CUDA tensor on a
    group whose backend moves host memory only (gloo)."""
    return t.is_cuda and dist.get_backend(group) != dist.Backend.NCCL


def _to_host(ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Pinned host copies, after the current stream has produced `ts`."""
    torch.cuda.current_stream().synchronize()
    return [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t) for t in ts]


def ring_shift(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str = "model") -> List[torch.Tensor]:
    """Each rank sends `tensors` to the next rank along `axis` (m + 1) and
    returns what the previous one (m - 1) sent: `lax.ppermute` over the ring
    i -> i + 1. Every rank sends tensors of the same shapes and dtypes."""
    size = mesh.size(axis)
    if size == 1:
        return list(tensors)
    group, line, m = mesh.groups[axis], mesh.ranks[axis], mesh.coords[axis]
    dst, src = line[(m + 1) % size], line[(m - 1) % size]
    staged = _staged(tensors[0], group)
    send = _to_host(tensors) if staged else [t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i) for i, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag=i) for i, t in enumerate(recv)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        return [r.to(t.device, non_blocking=True) for r, t in zip(recv, tensors)]
    return recv


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The ranks' blocks of rows `t` (B, H, rows, D) along `axis`,
    concatenated along the token axis in the order of their coordinates (a
    shard_map out_spec over that axis)."""
    size = mesh.size(axis)
    if size == 1:
        return t
    group = mesh.groups[axis]
    staged = _staged(t, group)
    src = _to_host([t])[0] if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=2)
    return out.to(t.device, non_blocking=True) if staged else out


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The sum of the ranks' `t` along `axis` (`lax.psum`), on every rank."""
    if mesh.size(axis) == 1:
        return t
    group = mesh.groups[axis]
    staged = _staged(t, group)
    out = _to_host([t])[0] if staged else t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device, non_blocking=True) if staged else out
