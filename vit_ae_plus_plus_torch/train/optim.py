"""Optimizer and learning-rate schedule of SSL pretraining.

Counterpart of the JAX package's train/optim.py (`warmup_cosine_schedule`,
`weight_decay_mask`, `make_adamw`), with optax's semantics:

- AdamW(0.9, 0.95), eps 1e-8, as `torch.optim.AdamW` over two parameter
  groups: decay for every parameter with ndim > 1 (cls_token and
  mask_token included), none for biases and norm scales;
- update k (counted from 0, as optax counts) uses the learning rate
  `schedule(k)`;
- `clip_grad`: optax's `clip_by_global_norm`, applied before the update.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

Schedule = Callable[[int], float]


def warmup_cosine_schedule(
    base_lr: float, min_lr: float, warmup_epochs: float, total_epochs: float, steps_per_epoch: int
) -> Schedule:
    """Per-step learning rate: linear warmup over fractional epochs, then a
    half cosine down to `min_lr` (epoch = step / steps_per_epoch)."""

    def schedule(count: int) -> float:
        epoch = count / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        denom = max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom)
        )

    return schedule


def weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True (decay) for weight matrices and tokens (ndim > 1); biases and
    norm scales are exempt."""
    return {name: p.ndim > 1 for name, p in named_params}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax `global_norm`),
    accumulated in at least f32, without a host sync."""
    sq = [t.to(torch.promote_types(t.dtype, torch.float32)).pow(2).sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


class AdamW:
    """optax's masked AdamW chain over a module's parameters: global-norm
    clipping (optional), then `torch.optim.AdamW` with the learning rate of
    the update's count. `step()` reads the parameters' `.grad`."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: Union[Schedule, float],
        weight_decay: float = 0.05,
        b1: float = 0.9,
        b2: float = 0.95,
        clip_grad: Optional[float] = None,
    ):
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        decay = weight_decay_mask(named)
        self.params = [p for _, p in named]
        self.schedule = learning_rate if callable(learning_rate) else (lambda _k: learning_rate)
        self.clip_grad = clip_grad
        self.count = 0
        self.opt = torch.optim.AdamW(
            [
                {"params": [p for n, p in named if decay[n]], "weight_decay": weight_decay},
                {"params": [p for n, p in named if not decay[n]], "weight_decay": 0.0},
            ],
            lr=self.schedule(0), betas=(b1, b2), eps=1e-8,
        )

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_grad is not None:
            norm = global_norm(grads)
            keep = norm < self.clip_grad
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip_grad))
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def make_adamw(
    learning_rate: Union[Schedule, float],
    weight_decay: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.95,
    clip_grad: Optional[float] = None,
    accum_iter: int = 1,
) -> Callable[[nn.Module], AdamW]:
    """The optimizer's recipe, as the JAX package's `make_adamw` returns an
    optax transformation: call it on the model (`create_train_state` does)
    to get the `AdamW` over its parameters."""
    if accum_iter > 1:
        raise NotImplementedError("gradient accumulation (accum_iter > 1) is not ported yet")

    def init(model: nn.Module) -> AdamW:
        return AdamW(model, learning_rate, weight_decay, b1, b2, clip_grad)

    return init
