"""Sequence-sharded attention: q sharded over the mesh, K/V replicated.

Counterpart of the JAX package's kernels/seq_flash.py
(`seq_sharded_flash_attention`, a `jax.custom_vjp` over `shard_map`s of the
per-head TPU kernels). No kernel of its own: each rank runs the per-head
kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu, counted on `flash_attention`
and `flash_attention_bwd`) on its shard of the query rows against all N keys
(the kernels' kv_len):

- q is padded to `8 * P` rows (P ranks in the mesh's 'model' group) and rank
  m takes rows [m * pn / P, (m + 1) * pn / P); k and v stay whole.
- Forward: o and lse of the local rows; o is all-gathered over the group.
- Backward: dq is row-local and all-gathered; dk and dv are partial sums
  over the local rows, summed over the group (`all_reduce_sum`, the JAX
  package's `lax.psum`), in f32.

As in kernels/ring_flash.py, the trunk around attention is replicated over
the 'model' group: every rank passes the full (B, H, N, D) tensors and gets
the full o and the full gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from vit_ae_plus_plus_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce_sum, local_rows


class _SeqShardedAttention(torch.autograd.Function):
    """seq_flash.py:39-79: local query rows, replicated K/V, summed dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, mesh: Mesh, axis: str, scale: float):
        q_l = local_rows(q, mesh, axis)
        o_l, lse = flash_attention_fwd(q_l, k, v, scale)
        ctx.save_for_backward(q_l, k, v, o_l, lse)
        ctx.mesh, ctx.axis, ctx.scale, ctx.n = mesh, axis, scale, q.shape[2]
        return all_gather_rows(o_l, mesh, axis)[:, :, :ctx.n]

    @staticmethod
    def backward(ctx, do):
        q_l, k, v, o_l, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        do_l = local_rows(do, mesh, axis)  # the pad rows' gradient is 0
        dq, dk, dv = flash_attention_bwd(q_l, k, v, o_l, lse, do_l, ctx.scale)
        dq = all_gather_rows(dq, mesh, axis)[:, :, :ctx.n]
        dk, dv = (all_reduce_sum(g.float(), mesh, axis).to(k.dtype) for g in (dk, dv))
        return dq, dk, dv, None, None, None


def seq_sharded_flash_attention(q, k, v, mesh: Mesh, axis: str = "model", scale: Optional[float] = None):
    """softmax(q k^T * scale) v over (B, H, N, D) with the query rows sharded
    over `mesh`'s `axis` group and K/V replicated; differentiable in q, k
    and v. Exact: the pad rows are sliced off and contribute nothing to any
    gradient."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _SeqShardedAttention.apply(q, k, v, mesh, axis, scale)
