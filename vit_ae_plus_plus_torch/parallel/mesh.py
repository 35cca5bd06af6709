"""The ('data', 'model') and ('data', 'pipe') meshes of a torch.distributed
world and their transport.

Counterpart of the JAX package's parallel/mesh.py (`make_mesh`), of
parallel/pp.py's `make_pipeline_mesh` and of `jax.set_mesh` /
`get_abstract_mesh`. JAX runs one program over a mesh of devices; here
every rank of an initialised `torch.distributed` world is one position of
the mesh, rank = d * model + m (d * pipe + p), and runs its own program:

- `make_mesh(data, model)` builds the process groups of both axes (every
  rank of the world must call it, as `torch.distributed.new_group` asks)
  and returns this rank's `Mesh`: the groups, the axes' sizes and its
  coordinates. `make_pipeline_mesh(pipe, data)` builds the ('data',
  'pipe') mesh of the GPipe pipeline (parallel/pp.py) the same way; an
  axis a mesh does not have has size 1 (`Mesh.size`), so every reader of
  the 'model' axis sees 1 on a pipeline's mesh.
- `set_mesh(mesh)` makes it the ambient mesh of a `with` block, as
  `jax.set_mesh` does; `get_mesh()` reads it (None outside). The
  sequence-parallel attention ('flash_ring', 'flash_seq') reads it.
- The data axis only names the groups: slicing the batch over it is the
  caller's work (`data_coords` gives this rank's coordinate on it). The
  data-parallel steps reduce over the 'data' group, the attention paths
  shard over the 'model' group.

Transport (`ring_shift`, `all_gather_rows`, `all_gather_batch`, the
serving mesh's `scatter_batch`, `all_reduce_sum`, the differentiable
`psum`, `all_reduce_flat`, the
shard transport of the sharded training state: `all_gather_dim`,
`reduce_scatter_dim`, the differentiable `gather_shards`, `sum_over`;
and the pipeline's hops along 'pipe': `send_to`, `recv_from`,
`broadcast_from`, and the differentiable `from_first` and `from_last`)
follows the group's backend. An NCCL group moves CUDA tensors itself. A gloo group moves
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
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_AXES = ("data", "model")  # make_mesh's; make_pipeline_mesh's are ("data", "pipe")
_current: contextvars.ContextVar = contextvars.ContextVar("vit_ae_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) or (data, pipe) grid of ranks:
    the axes' sizes, its coordinates, and for each axis the global ranks
    along it and their process group."""

    shape: dict  # {"data": D, "model": M} or {"data": D, "pipe": S}
    coords: dict  # {"data": d, "model": m} or {"data": d, "pipe": p}
    ranks: dict  # axis -> global ranks along it through this rank, by coordinate
    groups: dict  # axis -> its ProcessGroup (None for a one-rank axis)

    def size(self, axis: str) -> int:
        """The axis' size; 1 for an axis this mesh does not have."""
        return self.shape.get(axis, 1)


def make_mesh(data: int, model: int = 1) -> Optional[Mesh]:
    """The ('data', 'model') mesh over the first data * model ranks of the
    initialised default group, global rank d * model + m at (d, m). Every
    rank of the world calls it; a rank outside the mesh gets None. As in
    the JAX package, a mesh smaller than the world warns."""
    return _grid(data, model, "model")


def make_pipeline_mesh(pipe: int, data: int = 1) -> Optional[Mesh]:
    """The ('data', 'pipe') mesh of the GPipe pipeline (JAX parallel/pp.py
    `make_pipeline_mesh`): global rank d * pipe + p at (d, p), as JAX's
    `reshape(data, pipe)` places devices, so a stage's neighbours are the
    adjacent ranks. Collective, as `make_mesh`."""
    return _grid(data, pipe, "pipe")


def _grid(data: int, inner: int, axis: str) -> Optional[Mesh]:
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if data * inner > world:
        raise ValueError(f"mesh {data}x{inner} needs {data * inner} ranks, the world has {world}")
    if data * inner < world:
        warnings.warn(f"mesh {data}x{inner} uses only {data * inner} of {world} ranks", stacklevel=3)
    ranks = list(range(data * inner))
    grid = [ranks[d * inner:(d + 1) * inner] for d in range(data)]
    lines = {axis: grid, "data": [list(col) for col in zip(*grid)]}
    me = dist.get_rank()
    mine, groups = {}, {}
    for name in ("data", axis):
        for line in lines[name]:
            # new_group is collective over the world: every rank creates every group
            group = dist.new_group(line) if len(line) > 1 else None
            if me in line:
                mine[name], groups[name] = line, group
    if me not in ranks:
        return None
    return Mesh(
        shape={"data": data, axis: inner},
        coords={"data": me // inner, axis: me % inner},
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


def data_coords(mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(d, D): the coordinate of this rank on the 'data' axis of `mesh` (the
    ambient mesh by default) and the axis' size; (0, 1) without a mesh."""
    mesh = get_mesh() if mesh is None else mesh
    return (mesh.coords["data"], mesh.size("data")) if mesh is not None else (0, 1)


def barrier(mesh: Optional[Mesh], axis: str = "data") -> None:
    """Wait until every rank along `axis` has reached this call."""
    if mesh is not None and mesh.size(axis) > 1:
        dist.barrier(group=mesh.groups[axis])


def _other_axes(mesh: Mesh) -> List[str]:
    """The mesh's axes other than 'data' with more than one rank."""
    return [a for a in mesh.shape if a != "data" and mesh.size(a) > 1]


def is_writer(mesh: Optional[Mesh] = None) -> bool:
    """Whether this rank is the mesh's first (every coordinate 0), the one
    that writes a run's files; True without a mesh."""
    mesh = get_mesh() if mesh is None else mesh
    return mesh is None or not any(mesh.coords.values())


def mesh_barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank of the mesh has reached this call: along
    'data', then along the other axes (a rank passes the second only once
    its whole line has passed the first)."""
    if mesh is not None:
        for axis in ("data", *_other_axes(mesh)):
            barrier(mesh, axis)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """The writer's (`is_writer`) `obj` on every rank of the mesh: along
    the other axes among the ranks of data coordinate 0, then along
    'data'. -> the writer's object."""
    box = [obj]
    if mesh is None:
        return obj
    for axis in (*_other_axes(mesh), "data"):
        if mesh.size(axis) > 1 and (axis == "data" or mesh.coords["data"] == 0):
            dist.broadcast_object_list(box, src=mesh.ranks[axis][0], group=mesh.groups[axis])
    return box[0]


def data_parallel(n_devices: Optional[int], what: str, pipe: int = 1) -> Tuple[int, int]:
    """(d, D) of the ambient mesh (`data_coords`), after checking that it is
    the data mesh a pipeline was asked for: `n_devices` > 1 runs as that
    many ranks, each under a mesh of (n_devices, 1) (the CLI's
    `--n-devices` launches them); None takes the ambient mesh as it is.
    `pipe` > 1 (`pretrain-kfold --pipe-devices`): the mesh must be the
    ('data', 'pipe') mesh of that many stages, `n_devices` its data size."""
    mesh = get_mesh()
    d, size = data_coords(mesh)
    stages = mesh.size("pipe") if mesh is not None else 1
    if stages != pipe:
        raise ValueError(
            f"{what}: pipe_devices={pipe} runs under a pipeline mesh of {pipe} stages "
            f"(make_pipeline_mesh, as the CLI's --pipe-devices launches it), but this process sits on a "
            f"'pipe' axis of {stages}")
    if mesh is not None and mesh.size("model") > 1:
        # the pipelines write from the 'data' group's first rank, and, as the
        # JAX package's, build a data mesh only (--n-devices); the (D, M > 1)
        # steps run through make_train_step and parallel.tp / parallel.fsdp
        raise NotImplementedError(
            f"{what}: a mesh with model={mesh.size('model')} is not a pipeline's mesh: the pipelines run on "
            "the data mesh of --n-devices, (D, 1), as the JAX package's do; the (D, M > 1) training step "
            "runs through make_train_step (train/step.py)")
    if n_devices is not None and max(n_devices, 1) != size:
        raise ValueError(
            f"{what}: n_devices={n_devices} trains on {n_devices} ranks, each under a data mesh of "
            f"{n_devices} (parallel.run_ranks + set_mesh(make_mesh({n_devices})), as the CLI's --n-devices "
            f"launches them), but this process sits on a 'data' axis of {size}")
    return d, size


def writer_first(fn, mesh: Optional[Mesh] = None):
    """`fn()` on the mesh's first rank (`is_writer`), then on the others
    once it has returned: for a call that may write the files that the
    others then read (the fold index files). -> its result on this rank."""
    mesh = get_mesh() if mesh is None else mesh
    first = is_writer(mesh)
    out = fn() if first else None
    mesh_barrier(mesh)
    return out if first else fn()


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


def all_gather_batch(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The ranks' batch rows `t` (b, ...) along `axis`, concatenated along
    dim 0 in the order of their coordinates: the global batch of a batch
    sharded `P('data')`. Every rank passes the same shape. Not
    differentiable."""
    size = mesh.size(axis)
    if size == 1:
        return t
    group = mesh.groups[axis]
    staged = _staged(t, group)
    src = _to_host([t])[0] if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0)
    return out.to(t.device, non_blocking=True) if staged else out


def scatter_batch(t: Optional[torch.Tensor], mesh: Mesh, shape: Sequence[int], dtype: torch.dtype,
                  device: torch.device, axis: str = "data") -> torch.Tensor:
    """This rank's block of rows of the batch `t` (`shape`, `dtype`) that
    the axis' first rank holds, cut into one block per rank in the order of
    their coordinates: a batch placed `P('data')`. The other ranks pass
    None. An NCCL group scatters from `device`; a gloo group from host
    memory (the first rank's `t` may stay there), and the block comes back
    to `device`. -> the block on `device`."""
    size = mesh.size(axis)
    if size == 1:
        return t.to(device, non_blocking=True)
    group = mesh.groups[axis]
    nccl = dist.get_backend(group) == dist.Backend.NCCL
    rows = shape[0] // size
    buf = torch.empty((rows, *shape[1:]), dtype=dtype, device=device if nccl else "cpu",
                      pin_memory=not nccl and device.type == "cuda")
    parts = None
    if mesh.coords[axis] == 0:
        if t.is_cuda and not nccl:
            t = _to_host([t])[0]
        parts = [c.contiguous() for c in t.to(buf.device).split(rows)]
    dist.scatter(buf, parts, src=mesh.ranks[axis][0], group=group)
    return buf.to(device, non_blocking=True)


class _PSum(torch.autograd.Function):
    """`all_reduce_sum` whose backward is the same sum of the incoming
    gradients: every rank's loss depends on every rank's input through the
    sum, so the gradient of the summed losses wrt one input sums the
    ranks' gradients wrt the output (`lax.psum`'s transpose)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce_sum(t, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.mesh, ctx.axis), None, None


def psum(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The differentiable sum of the ranks' `t` along `axis`, on every rank."""
    if mesh.size(axis) == 1:
        return t
    return _PSum.apply(t, mesh, axis)


def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """The sums of the ranks' `tensors` along `axis`, in one all-reduce per
    dtype: the tensors are flattened into one buffer (staged to host
    memory once on a gloo group), summed, and cut back into new tensors
    of the inputs' shapes."""
    if mesh.size(axis) == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        total = all_reduce_sum(flat, mesh, axis)
        for i, part in zip(idx, torch.split(total, [tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def all_gather_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' shards `t` along `axis`, concatenated along `dim` in the
    order of their coordinates: a leaf sharded over `axis` on `dim`, whole.
    Every rank passes the same shape. Not differentiable (`gather_shards`
    is)."""
    size = mesh.size(axis)
    if size == 1:
        return t
    group = mesh.groups[axis]
    staged = _staged(t, group)
    src = _to_host([t])[0] if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device, non_blocking=True) if staged else out


def reduce_scatter_dim(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of the ranks' `t` along
    `axis`: the shard of a summed gradient. An NCCL group reduce-scatters;
    a gloo group, which has no reduce-scatter for this use, sums the whole
    tensor (through pinned host memory, as `all_reduce_sum` does) and
    keeps the block."""
    size = mesh.size(axis)
    if size == 1:
        return t
    group, i = mesh.groups[axis], mesh.coords[axis]
    if t.is_cuda and dist.get_backend(group) == dist.Backend.NCCL:
        chunks = [c.contiguous() for c in t.chunk(size, dim=dim)]
        out = torch.empty_like(chunks[i])
        dist.reduce_scatter(out, chunks, op=dist.ReduceOp.SUM, group=group)
        return out
    return all_reduce_sum(t, mesh, axis).chunk(size, dim=dim)[i].contiguous()


class _GatherShards(torch.autograd.Function):
    """`all_gather_dim` whose backward reduce-scatters the gradient of the
    whole leaf back to this rank's shard (summed over the ranks: each rank's
    loss reaches the leaf through its own gather)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather_dim(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_dim(grad, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def gather_shards(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The differentiable whole of a leaf sharded over `axis` on `dim`."""
    if mesh.size(axis) == 1:
        return t
    return _GatherShards.apply(t, mesh, axis, dim)


def sum_over(values: torch.Tensor, axes: Sequence[Tuple[str, ...]], mesh: Optional[Mesh]) -> torch.Tensor:
    """The vector `values` with entry i summed over the ranks of the mesh
    axes `axes[i]` (a sum of squares of a leaf sharded over those axes; ()
    for a replicated one, left as it is): one all-reduce of the entries of
    each sharded axis set."""
    out = values
    for key in sorted({a for a in axes if a}):
        idx = torch.tensor([i for i, a in enumerate(axes) if a == key], device=values.device)
        part = values[idx]
        for axis in key:
            part = all_reduce_sum(part, mesh, axis)
        out = out.index_put((idx,), part)
    return out


class _Sent:
    """An `isend` in flight and the buffer it reads (kept alive until
    `wait` returns)."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()
        self.buf = None


def send_to(t: torch.Tensor, mesh: Mesh, axis: str, coord: int, tag: int = 0) -> _Sent:
    """Start sending `t` to the rank at `coord` along `axis` (a CUDA tensor
    on gloo through a pinned host copy, once the current stream has
    produced it) -> its handle; `wait()` it before the run moves on."""
    group = mesh.groups[axis]
    buf = _to_host([t])[0] if _staged(t, group) else t.contiguous()
    return _Sent(dist.isend(buf, mesh.ranks[axis][coord], group=group, tag=tag), buf)


def recv_from(like: torch.Tensor, mesh: Mesh, axis: str, coord: int, tag: int = 0) -> torch.Tensor:
    """What the rank at `coord` along `axis` sends (`send_to`): a tensor of
    `like`'s shape and dtype on its device."""
    group = mesh.groups[axis]
    staged = _staged(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if staged else torch.empty(
        like.shape, dtype=like.dtype, device=like.device)
    dist.irecv(buf, mesh.ranks[axis][coord], group=group, tag=tag).wait()
    return buf.to(like.device, non_blocking=True) if staged else buf


def broadcast_from(t: torch.Tensor, mesh: Mesh, axis: str, coord: int) -> torch.Tensor:
    """The tensor `t` of the rank at `coord` along `axis`, on every rank of
    it (the others pass a tensor of the same shape and dtype, whose values
    are not read). Not differentiable (`from_first`, `from_last` are)."""
    if mesh.size(axis) == 1:
        return t
    group = mesh.groups[axis]
    staged = _staged(t, group)
    if mesh.coords[axis] == coord:
        buf = _to_host([t])[0] if staged else t.contiguous()
    else:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=staged,
                          device="cpu" if staged else t.device)
    dist.broadcast(buf, src=mesh.ranks[axis][coord], group=group)
    return buf.to(t.device, non_blocking=True) if staged else buf


class _FromFirst(torch.autograd.Function):
    """Identity forward; backward, the first rank's gradient along the
    axis on every rank of it: the transpose of a replicated input that only
    the first rank consumes (JAX's `where(idx == 0, ...)` inside a
    shard_map, whose gradient is psum'd over the axis, the other ranks'
    parts being zeros)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return broadcast_from(grad, ctx.mesh, ctx.axis, 0), None, None


class _FromLast(torch.autograd.Function):
    """Forward, the last rank's `t` along the axis on every rank of it;
    backward, the gradient on the last rank and none elsewhere: every rank
    computes the same function of the one output, so the last rank takes
    its gradient once, as JAX's masked psum transposes (not summed over the
    axis)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.last = mesh.coords[axis] == mesh.size(axis) - 1
        return broadcast_from(t, mesh, axis, mesh.size(axis) - 1)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else None), None, None


def from_first(t: torch.Tensor, mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """`t`, whose gradient is the axis' first rank's (`_FromFirst`)."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    return _FromFirst.apply(t, mesh, axis)


def from_last(t: torch.Tensor, mesh: Mesh, axis: str = "pipe") -> torch.Tensor:
    """The axis' last rank's `t` on every rank, differentiable
    (`_FromLast`)."""
    if mesh is None or mesh.size(axis) == 1:
        return t
    return _FromLast.apply(t, mesh, axis)
