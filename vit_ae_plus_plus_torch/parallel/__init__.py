"""Process-group meshes for the port's data-parallel steps, its
sequence-parallel attention and its GPipe pipeline (counterpart of the JAX
package's parallel/mesh.py and, for the pipeline, of what its
parallel/__init__.py exports of parallel/pp.py), and `run_ranks`, which
starts a world of spawned ranks."""

from vit_ae_plus_plus_torch.parallel.launch import run_ranks
from vit_ae_plus_plus_torch.parallel.mesh import (
    Mesh,
    all_gather_batch,
    all_gather_rows,
    all_reduce_flat,
    all_reduce_sum,
    barrier,
    broadcast_object,
    data_coords,
    data_parallel,
    from_first,
    from_last,
    get_mesh,
    is_writer,
    local_rows,
    make_mesh,
    make_pipeline_mesh,
    mesh_barrier,
    padded_len,
    psum,
    ring_shift,
    set_mesh,
    writer_first,
)
from vit_ae_plus_plus_torch.parallel.pp import (
    auto_microbatches,
    make_pp_train_step,
    pipeline_blocks,
    pipelined_forward_features,
    pipelined_mae_forward,
    pp_param_shardings,
    shard_pipeline_state,
)

__all__ = [
    "Mesh",
    "all_gather_batch",
    "all_gather_rows",
    "all_reduce_flat",
    "all_reduce_sum",
    "auto_microbatches",
    "barrier",
    "broadcast_object",
    "data_coords",
    "data_parallel",
    "from_first",
    "from_last",
    "get_mesh",
    "is_writer",
    "local_rows",
    "make_mesh",
    "make_pipeline_mesh",
    "make_pp_train_step",
    "mesh_barrier",
    "pipeline_blocks",
    "pipelined_forward_features",
    "pipelined_mae_forward",
    "pp_param_shardings",
    "padded_len",
    "psum",
    "ring_shift",
    "run_ranks",
    "set_mesh",
    "shard_pipeline_state",
    "writer_first",
]
