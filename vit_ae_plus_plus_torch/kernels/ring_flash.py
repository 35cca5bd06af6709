"""Ring flash attention: q, k and v sharded over the sequence, K/V rotating.

Counterpart of the JAX package's kernels/ring_flash.py (`ring_flash_attention`,
one `jax.custom_vjp` over a `shard_map`ped schedule of the TPU kernels
`_partial_fwd` and `_partial_bwd`):

- The token axis is padded to `8 * P` rows (P ranks in the mesh's 'model'
  group) and cut into P blocks of `nb` rows; rank m owns block m of q, k
  and v. Validity is data: an f32 bias over each block's keys, 0 for a
  valid key and -1e30 for a pad key, travels round the ring with its block
  (which block holds the ragged tail is a per-rank fact).
- Forward: P steps. Each runs `ring_partial_fwd` (csrc/flash_fwd.cu with the
  bias) of the rank's query rows against the block it holds, merges the
  partial (o, lse) into the running one in f32 (`merge`, the log-sum-exp
  combine) and passes (k, v, bias) on to rank m + 1: P - 1 rotations.
- Backward: P steps of `ring_partial_bwd` (csrc/flash_bwd.cu with the bias)
  from the MERGED o and lse of the rank's rows. dq accumulates in place; dk
  and dv accumulate in f32 and travel with their block, and after the last
  step one more hop takes each block's gradient home: P rotations. Each
  step's kernel outputs are in q's dtype and are summed in f32, as in JAX.
- The whole schedule is one `torch.autograd.Function`.

A rank runs its own program, not a GSPMD-partitioned one, so the trunk
around attention is replicated over the 'model' group: the Function takes
the full (B, H, N, D) q, k and v on every rank, computes its own rows, and
all-gathers o over the group. Its backward slices its rows of the output
gradient, runs the ring backward and all-gathers dq, dk and dv, so every
rank ends with the full gradients. Only attention is sequence-parallel:
sharding the token-wise layers too is later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels.flash_attention import attention_bwd, attention_fwd
from vit_ae_plus_plus_torch.parallel.mesh import Mesh, all_gather_rows, local_rows, padded_len, ring_shift

NEG_INF = -1e30  # a pad key's bias (the JAX package's pallas_flash._NEG_INF)
MAX_BLOCK = 2048  # rows per ring block: the JAX package's one contract for the ring


def ring_partial_fwd(q, k, v, bias, scale: float):
    """One ring step: (o, lse) of the local query rows q (B, H, NQ, D)
    against the held block k, v (B, H, NB, D) with its key bias (NB,) f32.
    o in q's dtype, lse (B, H, NQ) f32. The forward kernel on CUDA tensors
    (counted here), the plain version on CPU tensors."""
    return attention_fwd(q, k, v, scale, bias, ring_partial_fwd)


def ring_partial_bwd(q, do, o, lse, k, v, bias, scale: float):
    """One ring step's (dq, dk, dv) against the held block, from the merged
    o and lse of the local rows: the backward kernel on CUDA tensors
    (counted here), the plain version on CPU tensors."""
    return attention_bwd(q, k, v, o, lse, do, scale, bias, ring_partial_bwd)


ring_partial_fwd.launches = 0  # kernel launches since the last reset
ring_partial_fwd.launches_by_shape = {}
ring_partial_bwd.launches = 0
ring_partial_bwd.launches_by_shape = {}


def merge(o, lse, o_s, lse_s):
    """f32 log-sum-exp combine of two normalised partials: o (B, H, NQ, D)
    f32 and lse (B, H, NQ) with a step's o_s (any dtype) and lse_s."""
    lse_new = torch.logaddexp(lse, lse_s)
    w = torch.exp(lse - lse_new)[..., None]
    w_s = torch.exp(lse_s - lse_new)[..., None]
    return o * w + o_s.float() * w_s, lse_new


class _RingFlashAttention(torch.autograd.Function):
    """The ring schedule forward and backward (ring_flash.py:234-287)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh: Mesh, axis: str, scale: float):
        n_shards, n = mesh.size(axis), q.shape[2]
        q_l, k_l, v_l = (local_rows(t, mesh, axis) for t in (q, k, v))
        nb, m = q_l.shape[2], mesh.coords[axis]
        key = torch.arange(m * nb, (m + 1) * nb, device=q.device)
        bias_l = torch.where(key < n, 0.0, NEG_INF).float()
        kb, vb, bb = k_l, v_l, bias_l
        o = lse = None
        for s in range(n_shards):
            o_s, lse_s = ring_partial_fwd(q_l, kb, vb, bb, scale)
            o, lse = (o_s.float(), lse_s) if o is None else merge(o, lse, o_s, lse_s)
            if s < n_shards - 1:
                kb, vb, bb = ring_shift((kb, vb, bb), mesh, axis)
        o_l = o.to(q.dtype)
        ctx.save_for_backward(q_l, k_l, v_l, bias_l, o_l, lse)
        ctx.mesh, ctx.axis, ctx.scale, ctx.n = mesh, axis, scale, n
        return all_gather_rows(o_l, mesh, axis)[:, :, :n]

    @staticmethod
    def backward(ctx, do):
        q_l, kb, vb, bb, o_l, lse = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n_shards = mesh.size(axis)
        do_l = local_rows(do, mesh, axis)  # the pad rows' gradient is 0
        dq = torch.zeros(q_l.shape, dtype=torch.float32, device=q_l.device)
        dk = torch.zeros(kb.shape, dtype=torch.float32, device=kb.device)
        dv = torch.zeros_like(dk)
        for s in range(n_shards):
            dq_s, dk_s, dv_s = ring_partial_bwd(q_l, do_l, o_l, lse, kb, vb, bb, ctx.scale)
            dq += dq_s.float()
            dk += dk_s.float()
            dv += dv_s.float()
            # the accumulators travel with their block; after the last step
            # one more hop delivers each block's gradient home
            if s < n_shards - 1:
                kb, vb, bb, dk, dv = ring_shift((kb, vb, bb, dk, dv), mesh, axis)
            else:
                dk, dv = ring_shift((dk, dv), mesh, axis)
        grads = (all_gather_rows(g.to(q_l.dtype), mesh, axis)[:, :, :ctx.n] for g in (dq, dk, dv))
        return (*grads, None, None, None)


def _check_ring(q, k, v, n_shards: int) -> None:
    """The JAX package's two refusals, raised before any collective: the
    self-attention shape check, and the block ceiling (`nb > 2048`)."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError("ring attention is for self-attention: q/k/v shapes "
                         f"must match, got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    nb = padded_len(q.shape[2], n_shards) // n_shards
    if nb > MAX_BLOCK:
        raise ValueError(
            f"per-shard ring block {nb} rows exceeds the {MAX_BLOCK}-row ring block "
            f"ceiling; shard the sequence over more than {n_shards} ranks"
        )


def ring_flash_attention(q, k, v, mesh: Mesh, axis: str = "model", scale: Optional[float] = None):
    """softmax(q k^T * scale) v over (B, H, N, D) with the sequence sharded
    over `mesh`'s `axis` group and K/V rotating round it; differentiable in
    q, k and v. Every rank passes the full tensors and gets the full o (see
    the module's docstring). Exact: pad rows carry a -1e30 key bias and are
    sliced off, and their output gradient is 0."""
    _check_ring(q, k, v, mesh.size(axis))
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _RingFlashAttention.apply(q, k, v, mesh, axis, scale)
