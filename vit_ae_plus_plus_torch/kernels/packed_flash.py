"""Packed-I/O attention: qkv stays in the projection's (B, N, 3C) layout.

Counterpart of the JAX package's kernels/packed_flash.py forward
(`packed_flash_attention`). The CUDA kernel (csrc/flash_fwd.cu) reads q, k
and v as three strided (B, N, H, d) views of the packed tensor and writes o
as (B, N, C) with C = H*d, so no per-head tensor is ever materialised. The
TPU kernel's 128-lane head groups and its limit of 2,048 padded tokens were
TPU layout choices and do not carry over: any N, and C need only be a
multiple of d.

Forward only: the backward kernel comes with training.
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_ae_plus_plus_torch.kernels.flash_attention import (
    DTYPES,
    HEAD_DIMS,
    attention_plain,
    launch_flash_fwd,
)


def _split(qkv: torch.Tensor, head_dim: int):
    """(B, N, 3C) -> q, k, v as (B, N, H, d) views (no copy)."""
    b, n, c3 = qkv.shape
    return qkv.view(b, n, 3, c3 // (3 * head_dim), head_dim).unbind(2)


def packed_attention_plain(qkv, head_dim: int, scale: float, return_lse: bool = False):
    """Eager reference of `packed_flash_attention` (f32 inside)."""
    b, n, c3 = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in _split(qkv, head_dim))  # (B, H, N, d)
    out = attention_plain(q, k, v, scale, return_lse)
    o, lse = out if return_lse else (out, None)
    o = o.transpose(1, 2).reshape(b, n, c3 // 3)
    return (o, lse) if return_lse else o


def _check(qkv: torch.Tensor, head_dim: int) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"expected qkv of shape (B, N, 3C), got {tuple(qkv.shape)}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} not in {HEAD_DIMS}")
    if (qkv.shape[-1] // 3) % head_dim:
        raise ValueError(f"C={qkv.shape[-1] // 3} is not a multiple of head_dim {head_dim}")
    if qkv.dtype not in DTYPES:
        raise ValueError(f"dtype {qkv.dtype} not in {DTYPES}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {qkv.device}")


def packed_flash_attention(
    qkv: torch.Tensor,
    head_dim: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """qkv (B, N, 3C), the fused projection's output -> o (B, N, C) in qkv's
    dtype; with `return_lse` also the f32 lse, (B, H, N).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. The last axis must be contiguous."""
    _check(qkv, head_dim)
    scale = head_dim ** -0.5 if scale is None else scale
    if qkv.device.type == "cpu":
        return packed_attention_plain(qkv, head_dim, scale, return_lse)
    b, n, c3 = qkv.shape
    h = c3 // (3 * head_dim)
    if qkv.stride(-1) != 1:
        raise ValueError("qkv's last axis must be contiguous")
    o = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=qkv.device) if return_lse else None
    q, k, v = _split(qkv, head_dim)
    launch_flash_fwd(q, k, v, o.view(b, n, h, head_dim), lse, scale)
    packed_flash_attention.launches += 1
    return (o, lse) if return_lse else o


packed_flash_attention.launches = 0  # kernel launches since the last reset
