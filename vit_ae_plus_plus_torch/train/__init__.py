"""Pretraining of the port: objective, optimizer, state, step, weight bridge."""

from vit_ae_plus_plus_torch.train.objective import mae_loss_terms
from vit_ae_plus_plus_torch.train.optim import make_adamw, warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.state import TrainState, create_train_state
from vit_ae_plus_plus_torch.train.step import make_train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "mae_loss_terms",
    "make_adamw",
    "make_train_step",
    "warmup_cosine_schedule",
]
