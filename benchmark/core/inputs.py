"""Inputs made from `--seed`: weights, volumes and masking noise.

Each is drawn on the run's device by a `torch.Generator` of its own stream
of the seed, in a few large calls, so the same seed gives the same inputs,
and the program and the reference each get them from here, never from one
another.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# stream numbers (< 16) of one seed
PARAMS, VIEWS = 0, 1


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for `stream` of `seed`: distinct for every (seed,
    stream) pair of a seed below 2**59."""
    return (int(seed) * 16 + stream) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def make_params(spec: List[Tuple[str, tuple, str]], seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 tensors for `spec` [(name, shape, kind)], views of one buffer
    drawn uniform in [-1, 1) in one call and scaled by kind: 'xavier'
    (a weight: limit sqrt(6 / (fan_in + fan_out)), fan_in the product of
    dims after the first), 'bias' (0.02), 'norm_w' (1 + 0.02 u), 'norm_b'
    (0.02), 'token' (0.02 sqrt 3: standard deviation 0.02)."""
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.rand(total, generator=generator(seed, PARAMS, device), device=device)
    flat = flat.mul_(2).sub_(1)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "xavier":
            fan_out, fan_in = shape[0], n // shape[0]
            t.mul_(math.sqrt(6.0 / (fan_in + fan_out)))
        elif kind in ("bias", "norm_b"):
            t.mul_(0.02)
        elif kind == "norm_w":
            t.mul_(0.02).add_(1.0)
        elif kind == "token":
            t.mul_(0.02 * math.sqrt(3.0))
        else:
            raise ValueError(f"unknown parameter kind {kind!r} for {name}")
        out[name] = t
    return out


def _volumes(g: torch.Generator, n: int, cfg: dict, device) -> torch.Tensor:
    """n smooth volumes (n, C, S, S, S): noise on a grid 8x coarser,
    trilinearly upsampled, with its own gain in [0.5, 1.5) and offset in
    [-0.5, 0.5) a volume, plus fine noise of 0.1 (volumes differ in scale,
    as scans before a per-batch mean do)."""
    s, c = cfg["volume_size"], cfg["in_chans"]
    coarse = torch.randn((n, c, s // 8, s // 8, s // 8), generator=g, device=device)
    v = F.interpolate(coarse, size=(s, s, s), mode="trilinear", align_corners=False)
    gain = torch.rand((n, 1, 1, 1, 1), generator=g, device=device) + 0.5
    offset = torch.rand((n, 1, 1, 1, 1), generator=g, device=device) - 0.5
    fine = torch.randn((n, c, s, s, s), generator=g, device=device)
    return v.mul_(gain).add_(offset).add_(fine, alpha=0.1)


def make_train_batches(cfg: dict, batch: int, n_batches: int, seed: int, device) -> List[dict]:
    """`n_batches` distinct batches {'view1', 'view2' (contrastive
    configurations), 'noise'}: two views of each volume (the second the
    first mirrored on x with its own fine noise) and the masking noise of
    every encoded row (2 batch rows when contrastive), uniform in [0, 1)."""
    g = generator(seed, VIEWS, device)
    s = cfg["volume_size"]
    n_patches = (s // cfg["patch_size"]) ** 3
    out = []
    for _ in range(n_batches):
        v1 = _volumes(g, batch, cfg, device)
        b = {"view1": v1}
        if cfg["contrastive"]:
            extra = torch.randn(v1.shape, generator=g, device=device)
            b["view2"] = v1.flip(-1).add_(extra, alpha=0.05)
        rows = 2 * batch if cfg["contrastive"] else batch
        b["noise"] = torch.rand((rows, n_patches), generator=g, device=device)
        out.append(b)
    return out

