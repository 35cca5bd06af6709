"""Process-group meshes for the port's data-parallel steps and
sequence-parallel attention (counterpart of the JAX package's
parallel/mesh.py), and `run_ranks`, which starts a world of spawned
ranks."""

from vit_ae_plus_plus_torch.parallel.launch import run_ranks
from vit_ae_plus_plus_torch.parallel.mesh import (
    Mesh,
    all_gather_batch,
    all_gather_rows,
    all_reduce_flat,
    all_reduce_sum,
    barrier,
    data_coords,
    data_parallel,
    get_mesh,
    local_rows,
    make_mesh,
    padded_len,
    psum,
    ring_shift,
    set_mesh,
    writer_first,
)

__all__ = [
    "Mesh",
    "all_gather_batch",
    "all_gather_rows",
    "all_reduce_flat",
    "all_reduce_sum",
    "barrier",
    "data_coords",
    "data_parallel",
    "get_mesh",
    "local_rows",
    "make_mesh",
    "padded_len",
    "psum",
    "ring_shift",
    "run_ranks",
    "set_mesh",
    "writer_first",
]
