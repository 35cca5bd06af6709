"""Train state: the model (parameters and BatchNorm statistics), its
optimizer, the step count and the generator of the masking noise.

Counterpart of the JAX package's train/state.py. PyTorch updates in place,
so the state is one mutable object that the step returns again; the random
stream is an explicit `torch.Generator` on the model's device instead of a
JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch import nn

from vit_ae_plus_plus_torch.train.optim import AdamW


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    tx: AdamW
    generator: torch.Generator  # masking noise
    step: int = 0

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics (flax's `batch_stats`)."""
        return {n: b for n, b in self.model.named_buffers() if n.endswith(("running_mean", "running_var"))}


def create_train_state(model: nn.Module, tx: Callable[[nn.Module], AdamW], seed: int = 0) -> TrainState:
    """Wrap a built (and loaded or initialised) model: the optimizer from
    `tx` (`make_adamw(...)`) and a masking-noise generator seeded with
    `seed` on the model's device."""
    device = next(model.parameters()).device
    return TrainState(model=model, tx=tx(model),
                      generator=torch.Generator(device=device).manual_seed(seed))
