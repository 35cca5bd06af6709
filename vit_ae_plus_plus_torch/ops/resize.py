"""Trilinear resizing with the JAX package's weights: `jax.image.resize(x,
shape, "trilinear")` under its default `antialias=True`, in f32 on a torch
tensor of any rank.

Every axis whose size changes gets a weight matrix (in, out), built as
`jax._src.image.scale.compute_weight_mat` builds it: half-pixel sample
positions `(j + 0.5) / scale - 0.5`, the triangle kernel `max(0, 1 - |x|)`
widened by `1 / scale` when downsampling (the antialias), each output's
weights divided by their sum (so samples near an edge are renormalised),
and the weights of an output whose sample lies outside the input zeroed.
The input is then contracted with each matrix, one axis at a time.

This is not `torch.nn.functional.interpolate(mode="trilinear")`: the two
agree when upsampling, but `interpolate` neither widens the kernel nor
renormalises at the edges, so they differ when downsampling (a 240x240x155
scan served at 96^3). Everything runs on the tensor's device.
"""

from __future__ import annotations

from typing import Sequence

import torch

_F32_EPS = 1.1920928955078125e-07  # np.finfo(np.float32).eps


def _axis_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """The (in_size, out_size) f32 weight matrix of one axis."""
    scale = out_size / in_size  # Python floats, as jax.image.resize computes them
    inv_scale = 1.0 / scale
    f32 = torch.float32
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32, device=device)
    sample = (torch.arange(out_size, dtype=f32, device=device) + 0.5) * torch.tensor(
        inv_scale, dtype=f32, device=device) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs() / kernel_scale
    weights = torch.clamp_min(1.0 - x, 0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize_trilinear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`x` resampled to `shape` (one size per axis of `x`, as
    `jax.image.resize` takes it) -> f32 on `x`'s device. Axes whose size
    does not change are left alone; the others are contracted one at a time,
    the one that shrinks most first (the cheapest order, which the
    einsum of `jax.image.resize` also picks for these contractions)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} has {len(shape)} sizes for a tensor of {x.ndim} axes")
    if any(s < 1 for s in shape) or any(s < 1 for s in x.shape):
        raise ValueError(f"cannot resize {tuple(x.shape)} to {shape}: every size must be positive")
    x = x.float()
    axes = [d for d in range(x.ndim) if x.shape[d] != shape[d]]
    for d in sorted(axes, key=lambda d: (shape[d] / x.shape[d], d)):
        w = _axis_weights(x.shape[d], shape[d], x.device)
        x = torch.tensordot(x, w, dims=([d], [0])).movedim(-1, d)
    return x.contiguous()
