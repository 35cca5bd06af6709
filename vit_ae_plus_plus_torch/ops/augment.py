"""Augmentation on the card: the port's copy of the JAX package's
ops/augment.py, the device-side equivalent of data/transforms.py with the
same parameter distributions:

- `random_affine_3d`: per-axis scale U(0.9, 1.1) and rotation
  U(-10deg, 10deg), trilinear resampling, zero padding (torchio's
  RandomAffine defaults);
- `random_noise`: gaussian, std ~ U(0, 0.1);
- `random_gamma`: exp(U(-0.3, 0.3)) on min-max-rescaled intensities.

`device_augment_batch` composes the three per volume and normalises both
views (`znorm_volume`, `minmax_volume` or EGD's `znorm_per_channel`), the
device-side replacement for the host loader's per-item work.

Random draws. The JAX package draws from keys; torch's streams are others.
So every random function is split into a draw, made from an explicit
`torch.Generator` on the tensor's device (`affine_draws`, `noise_draws`,
`gamma_draws`, `augment_draws` for a batch), and an apply that takes the
draws (scale and angles, the noise's sigma and field, gamma), which the
tests fill with the JAX package's draws. Each function takes one (C, S, S,
S) volume, or a batch (..., C, S, S, S) with each volume's draws along
the same leading dims, so `device_augment_batch` augments a batch in one
pass of each operation (the JAX package's `vmap`), not volume by
volume. A data-parallel rank draws for the global batch and applies its
rows' draws (`device_augment_batch(..., rows=(d, D))`), so the ranks
together augment as one process does.

Resampling. `method="shear"` (the default) is the JAX package's
decomposition of the affine into twelve one-axis passes, each a banded
contraction (`_affine_shear`): three Paeth shears per rotation and one
rescale per axis. Each pass interpolates linearly once, so twelve smooth
more than one trilinear sample: the result is the JAX package's shear, not
the exact sampler, which `method="gather"` is (`_affine_gather`). The
contractions are f32 `einsum`s, in f32 under PyTorch's default matmul
precision ("highest"), as the port's other f32 products are.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample (..., C, S, S, S) at real-valued coords (..., 3, N), each
    volume at its own; zeros outside. -> (..., C, N)."""
    lead, (c, sz, sy, sx), n = vol.shape[:-4], vol.shape[-4:], coords.shape[-1]
    vol = vol.reshape(-1, c, sz, sy, sx)
    z, y, x = coords.reshape(-1, 3, n).unbind(1)  # (B, N) each
    b = torch.arange(vol.shape[0], device=vol.device)[:, None]
    z0, y0, x0 = (torch.floor(t).to(torch.int64) for t in (z, y, x))
    fz, fy, fx = z - z0, y - y0, x - x0

    def gather(zi, yi, xi):
        valid = (zi >= 0) & (zi < sz) & (yi >= 0) & (yi < sy) & (xi >= 0) & (xi < sx)
        vals = vol[b, :, zi.clamp(0, sz - 1), yi.clamp(0, sy - 1), xi.clamp(0, sx - 1)]  # (B, N, C)
        return torch.where(valid[:, None, :], vals.transpose(1, 2), 0.0)

    out = (
        gather(z0, y0, x0) * ((1 - fz) * (1 - fy) * (1 - fx))[:, None]
        + gather(z0, y0, x0 + 1) * ((1 - fz) * (1 - fy) * fx)[:, None]
        + gather(z0, y0 + 1, x0) * ((1 - fz) * fy * (1 - fx))[:, None]
        + gather(z0, y0 + 1, x0 + 1) * ((1 - fz) * fy * fx)[:, None]
        + gather(z0 + 1, y0, x0) * (fz * (1 - fy) * (1 - fx))[:, None]
        + gather(z0 + 1, y0, x0 + 1) * (fz * (1 - fy) * fx)[:, None]
        + gather(z0 + 1, y0 + 1, x0) * (fz * fy * (1 - fx))[:, None]
        + gather(z0 + 1, y0 + 1, x0 + 1) * (fz * fy * fx)[:, None]
    )
    # scipy mode='constant' (the host path): a sample point outside the
    # domain is 0, no partial boundary blending
    in_domain = (z >= 0) & (z <= sz - 1) & (y >= 0) & (y <= sy - 1) & (x >= 0) & (x <= sx - 1)
    return torch.where(in_domain[:, None, :], out, 0.0).reshape(*lead, c, n)


def _rotation_matrix(angles: torch.Tensor) -> torch.Tensor:
    """rot(0, a0) @ rot(1, a1) @ rot(2, a2), data/transforms.py
    RandomAffine3D's composition (axis order 0, 1, 2); angles (..., 3) ->
    (..., 3, 3)."""

    def rot(axis, a):
        c_, s_ = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        if axis == 0:
            rows = ((one, zero, zero), (zero, c_, -s_), (zero, s_, c_))
        elif axis == 1:
            rows = ((c_, zero, s_), (zero, one, zero), (-s_, zero, c_))
        else:
            rows = ((c_, -s_, zero), (s_, c_, zero), (zero, zero, one))
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    return rot(0, angles[..., 0]) @ rot(1, angles[..., 1]) @ rot(2, angles[..., 2])


# "resample along the MOVED axis, band matrix indexed by the OTHER axis";
# vol is (..., C, Z, Y, X); W is (..., other_size, out_size, src_size), or
# (..., out_size, src_size) for the uniform (scale) passes keyed (moved, None)
_SHEAR_EINSUM = {
    (0, 1): "...yzu,...cuyx->...czyx",
    (0, 2): "...xzu,...cuyx->...czyx",
    (1, 0): "...zyu,...czux->...czyx",
    (1, 2): "...xyu,...czux->...czyx",
    (2, 0): "...zxu,...czyu->...czyx",
    (2, 1): "...yxu,...czyu->...czyx",
    (0, None): "...zu,...cuyx->...czyx",
    (1, None): "...yu,...czux->...czyx",
    (2, None): "...xu,...czyu->...czyx",
}


def _band_weights(pos: torch.Tensor, size: int) -> torch.Tensor:
    """pos (..., out) fractional source positions -> W (..., out, size), the
    two-tap linear-interpolation band; positions outside [0, size - 1]
    contribute 0 (zero padding)."""
    u0 = torch.floor(pos)
    f = pos - u0
    src = torch.arange(size, dtype=torch.float32, device=pos.device)
    u0 = u0[..., None]
    return (src == u0) * (1.0 - f)[..., None] + (src == u0 + 1.0) * f[..., None]


def _apply_shear(vol, moved: int, other, alpha, beta, center):
    """One elemental pass over (..., C, Z, Y, X), each volume with its own
    coefficient (alpha or beta, of shape (...)): pos = out + beta * (other
    - c_other) for a shear, or pos = (out - c) * alpha + c for a uniform
    rescale (other is None)."""
    sizes = vol.shape[-3:]
    n = sizes[moved]
    out_idx = torch.arange(n, dtype=torch.float32, device=vol.device)
    if other is None:
        pos = (out_idx - center[moved]) * torch.as_tensor(alpha)[..., None] + center[moved]  # (..., n)
    else:
        o_idx = torch.arange(sizes[other], dtype=torch.float32, device=vol.device) - center[other]
        pos = out_idx + torch.as_tensor(beta)[..., None, None] * o_idx[:, None]  # (..., other, n)
    return torch.einsum(_SHEAR_EINSUM[(moved, other)], _band_weights(pos, n), vol)


def _paeth_passes(axis: int, theta):
    """The elemental passes (moved, other, beta) of rot(axis) as
    data/transforms.py uses it: planes [(1, 2), (0, 2), (0, 1)]; axis 1 is
    the transposed convention (transforms.RandomAffine3D.rot)."""
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    if axis == 1:
        theta = -theta
    a = -torch.tan(theta / 2.0)
    s = torch.sin(theta)
    # R = X(a) Y(s) X(a): the leftmost factor first (map composition)
    return [(i, j, a), (j, i, s), (i, j, a)]


def _center(vol: torch.Tensor) -> torch.Tensor:
    return (torch.tensor(vol.shape[-3:], dtype=torch.float32, device=vol.device) - 1) / 2.0


def _affine_shear(vol: torch.Tensor, angles: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    center = _center(vol)
    out = vol
    for axis in range(3):
        for moved, other, beta in _paeth_passes(axis, angles[..., axis]):
            out = _apply_shear(out, moved, other, None, beta, center)
    for axis in range(3):
        out = _apply_shear(out, axis, None, 1.0 / scale[..., axis], None, center)
    return out


def _affine_gather(vol: torch.Tensor, angles: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Exact single-shot trilinear sampling (the scipy-parity path)."""
    center = _center(vol)
    mat = _rotation_matrix(angles) @ torch.diag_embed(1.0 / scale)
    grid = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=vol.device) for s in vol.shape[-3:]], indexing="ij"),
        dim=0).reshape(3, -1)
    src = mat @ (grid - center[:, None]) + center[:, None]
    return trilinear_sample(vol, src).reshape(vol.shape)


def _uniform(generator: torch.Generator, shape, low: float, high: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device) * (high - low) + low


def affine_draws(generator: torch.Generator, n: int, scales: float = 0.1, degrees: float = 10.0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scale (n, 3) ~ U(1 - scales, 1 + scales), angles (n, 3) in
    radians ~ U(-degrees, degrees) * pi / 180)."""
    scale = _uniform(generator, (n, 3), 1 - scales, 1 + scales, device)
    angles = _uniform(generator, (n, 3), -degrees, degrees, device) * (math.pi / 180.0)
    return scale, angles


def random_affine_3d(vol: torch.Tensor, scale: torch.Tensor, angles: torch.Tensor,
                     method: str = "shear") -> torch.Tensor:
    """(..., C, S, S, S) -> the same shape, each volume with its scale and
    angles (..., 3); an output voxel pulls from mat @ (p - c) + c, mat =
    R(angles) diag(1 / scale). `method="shear"`: the banded-contraction
    passes; `"gather"`: exact trilinear sampling."""
    if method == "shear":
        return _affine_shear(vol, angles, scale)
    if method == "gather":
        return _affine_gather(vol, angles, scale)
    raise ValueError(f"unknown method {method!r} (shear or gather)")


def noise_draws(generator: torch.Generator, shape, std: float = 0.1,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sigma (shape[0],) ~ U(0, std), field of `shape` ~ N(0, 1))."""
    sigma = _uniform(generator, (shape[0],), 0.0, std, device)
    return sigma, torch.randn(shape, generator=generator, device=device)


def _per_volume(t: torch.Tensor) -> torch.Tensor:
    """A per-volume scalar of shape (...) broadcast over (..., C, S, S, S)."""
    return t[..., None, None, None, None]


def random_noise(vol: torch.Tensor, sigma: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    return vol + _per_volume(sigma) * field


def gamma_draws(generator: torch.Generator, n: int, log_gamma: Tuple[float, float] = (-0.3, 0.3),
                device=None) -> torch.Tensor:
    """-> gamma (n,) = exp(U(log_gamma))."""
    return torch.exp(_uniform(generator, (n,), log_gamma[0], log_gamma[1], device))


_VOLUME_DIMS = (-4, -3, -2, -1)


def random_gamma(vol: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    vmin, vmax = vol.amin(dim=_VOLUME_DIMS, keepdim=True), vol.amax(dim=_VOLUME_DIMS, keepdim=True)
    unit = (vol - vmin) / torch.clamp(vmax - vmin, min=1e-8)
    return unit ** _per_volume(gamma) * (vmax - vmin) + vmin


def znorm_volume(vol: torch.Tensor) -> torch.Tensor:
    """Whole-volume z-score (population variance) of each (C, S, S, S)
    volume: data/brats.py `normalize_volume(use_z_score=True)`."""
    mean = vol.mean(dim=_VOLUME_DIMS, keepdim=True)
    return (vol - mean) / torch.sqrt(vol.var(dim=_VOLUME_DIMS, keepdim=True, unbiased=False))


def minmax_volume(vol: torch.Tensor) -> torch.Tensor:
    """Min-max of each volume to [-1, 1]: `normalize_volume(use_z_score=False)`."""
    vmin, vmax = vol.amin(dim=_VOLUME_DIMS, keepdim=True), vol.amax(dim=_VOLUME_DIMS, keepdim=True)
    return 2 * (vol - vmin) / torch.clamp(vmax - vmin, min=1e-8) - 1


def znorm_per_channel(vol: torch.Tensor) -> torch.Tensor:
    """Per-channel z-score over the spatial dims (EGD, egd.py:44-47)."""
    mean = vol.mean(dim=(-3, -2, -1), keepdim=True)
    var = vol.var(dim=(-3, -2, -1), keepdim=True, unbiased=False)
    return (vol - mean) / torch.sqrt(var)


def augment_draws(generator: torch.Generator, shape, device=None) -> Dict[str, torch.Tensor]:
    """One batch's draws for `augment_one`, by volume: `scale` and `angles`
    (B, 3), `sigma` (B,), `field` of the batch's `shape`, `gamma` (B,)."""
    n = shape[0]
    scale, angles = affine_draws(generator, n, device=device)
    sigma, field = noise_draws(generator, tuple(shape), device=device)
    return {"scale": scale, "angles": angles, "sigma": sigma, "field": field,
            "gamma": gamma_draws(generator, n, device=device)}


def augment_one(vol: torch.Tensor, draws: Dict[str, torch.Tensor], method: str = "shear") -> torch.Tensor:
    """The SSL policy on a (C, S, S, S) volume with its draws, or on a
    batch of them with theirs (what the JAX package's vmap of it does):
    affine, noise, gamma (k_fold_..._brats.py:93-97)."""
    vol = random_affine_3d(vol, draws["scale"], draws["angles"], method)
    vol = random_noise(vol, draws["sigma"], draws["field"])
    return random_gamma(vol, draws["gamma"])


def device_augment_batch(raw_batch: torch.Tensor, generator: Optional[torch.Generator] = None,
                         use_z_score: bool = True, per_channel: bool = False,
                         draws: Optional[Dict[str, torch.Tensor]] = None,
                         rows: Optional[Tuple[int, int]] = None,
                         method: str = "shear") -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, C, S, S, S) raw volumes -> (augmented_normed, original_normed), on
    the batch's device. The draws are `draws`, else `augment_draws` from
    `generator`; under `rows=(d, D)` the batch is rank d's b rows of a
    global batch of D * b, the draws are made for the global batch and rows
    [d b, (d + 1) b) of them applied. `per_channel` selects EGD's
    per-channel z-score."""
    if per_channel and use_z_score:
        norm = znorm_per_channel
    else:
        norm = znorm_volume if use_z_score else minmax_volume
    b = raw_batch.shape[0]
    if draws is None:
        d, size = rows if rows is not None else (0, 1)
        draws = augment_draws(generator, (size * b, *raw_batch.shape[1:]), device=raw_batch.device)
        draws = {k: v[d * b:(d + 1) * b] for k, v in draws.items()}
    raw_batch = raw_batch.float()
    return norm(augment_one(raw_batch, draws, method)), norm(raw_batch)
