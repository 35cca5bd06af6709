"""Packed-I/O attention: qkv stays in the projection's (B, N, 3C) layout.

Counterpart of the JAX package's kernels/packed_flash.py
(`packed_flash_attention`, a `jax.custom_vjp` over `_packed_fwd` and
`_packed_bwd`). The CUDA kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) read
q, k and v as three strided (B, N, H, d) views of the packed tensor and write
o as (B, N, C) with C = H*d, so no per-head tensor is ever materialised. The
backward writes dq, dk and dv as three strided views of one (B, N, 3C)
gradient: the counterpart of JAX's `concatenate([dq, dk, dv])`, with no
copy. The TPU kernel's 128-lane head groups and its limit of 2,048 padded
tokens were TPU layout choices and do not carry over: any N, and C need only
be a multiple of d.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels.flash_attention import (
    HEAD_DIMS,
    attention_bwd_plain,
    attention_plain,
    check_dtype,
    count_launch,
    kernel_operand,
    launch_flash_bwd,
    launch_flash_fwd,
)


def _split(qkv: torch.Tensor, head_dim: int):
    """(B, N, 3C) -> q, k, v as (B, N, H, d) views (no copy)."""
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, c3 // (3 * head_dim), head_dim).unbind(2)


def _heads(t: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, d) view."""
    b, n, c = t.shape
    return t.view(b, n, c // head_dim, head_dim).transpose(1, 2)


def packed_attention_plain(qkv, head_dim: int, scale: float, return_lse: bool = False):
    """Eager reference of `packed_flash_attention` (at least f32 inside)."""
    b, n, c3 = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in _split(qkv, head_dim))  # (B, H, N, d)
    out = attention_plain(q, k, v, scale, return_lse)
    o, lse = out if return_lse else (out, None)
    o = o.transpose(1, 2).reshape(b, n, c3 // 3)
    return (o, lse) if return_lse else o


def packed_attention_bwd_plain(qkv, o, lse, do, head_dim: int, scale: float):
    """Eager reference of `packed_flash_attention_bwd`: the gradient of qkv,
    (B, N, 3C), from the forward's o (B, N, C) and lse (B, H, N) and the
    output gradient do (B, N, C)."""
    b, n, c3 = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in _split(qkv, head_dim))
    grads = attention_bwd_plain(q, k, v, _heads(o, head_dim), lse, _heads(do, head_dim), scale)
    return torch.cat([g.transpose(1, 2).reshape(b, n, c3 // 3) for g in grads], dim=-1)


def _check(qkv: torch.Tensor, head_dim: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv of shape (B, N, 3C), got {tuple(qkv.shape)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if (qkv.shape[-1] // 3) % head_dim:
        raise ValueError(f"C={qkv.shape[-1] // 3} is not a multiple of head_dim {head_dim}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")
    check_dtype(qkv.dtype, qkv.device)
    if qkv.device.type == "cuda" and qkv.stride(-1) != 1:
        raise ValueError("qkv's last axis must be contiguous")


def packed_flash_attention_fwd(qkv: torch.Tensor, head_dim: int, scale: float):
    """(o, lse): the forward kernel on a CUDA tensor, the plain version on a
    CPU tensor. Not differentiable: `packed_flash_attention` is."""
    _check(qkv, head_dim)
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, head_dim, scale, return_lse=True)
    b, n, c3 = qkv.shape
    h = c3 // (3 * head_dim)
    o = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=qkv.device)
    launch_flash_fwd(*_split(qkv, head_dim), o.view(b, n, h, head_dim), lse, scale)
    count_launch(packed_flash_attention, b, h, n, head_dim, qkv.dtype)
    return o, lse


def packed_flash_attention_bwd(qkv, o, lse, do, head_dim: int, scale: float):
    """The gradient of qkv, (B, N, 3C): the backward kernel on CUDA tensors,
    `packed_attention_bwd_plain` on CPU tensors."""
    _check(qkv, head_dim)
    if qkv.device.type == "cpu":
        return packed_attention_bwd_plain(qkv, o, lse, do, head_dim, scale)
    b, n, c3 = qkv.shape
    h = c3 // (3 * head_dim)
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    o, do = (t.view(b, n, h, head_dim) for t in (o, kernel_operand(do)))
    launch_flash_bwd(*_split(qkv, head_dim), o, lse, do, *_split(dqkv, head_dim), scale)
    count_launch(packed_flash_attention_bwd, b, h, n, head_dim, qkv.dtype)
    return dqkv


packed_flash_attention_bwd.launches = 0  # backward-kernel launches since the last reset
packed_flash_attention_bwd.launches_by_shape = {}


class _PackedFlashAttention(torch.autograd.Function):
    """Counterpart of the `jax.custom_vjp` at packed_flash.py:304-332."""

    @staticmethod
    def forward(ctx, qkv, head_dim, scale):
        o, lse = packed_flash_attention_fwd(qkv, head_dim, scale)
        ctx.save_for_backward(qkv, o, lse)
        ctx.head_dim, ctx.scale = head_dim, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        qkv, o, lse = ctx.saved_tensors
        return packed_flash_attention_bwd(qkv, o, lse, do, ctx.head_dim, ctx.scale), None, None


def packed_flash_attention(
    qkv: torch.Tensor,
    head_dim: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """qkv (B, N, 3C), the fused projection's output -> o (B, N, C) in qkv's
    dtype, differentiable in qkv; with `return_lse` also the lse, (B, H, N)
    (not differentiable).

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels or raises. The last axis must be contiguous."""
    scale = head_dim ** -0.5 if scale is None else scale
    o, lse = _PackedFlashAttention.apply(qkv, head_dim, scale)
    return (o, lse) if return_lse else o


packed_flash_attention.launches = 0  # forward-kernel launches since the last reset
packed_flash_attention.launches_by_shape = {}
