"""Stage-2 contrastive ViT training: the `contrastive-train` command.

The port's counterpart of the JAX package's pipelines/contrastive.py (the
reference's dormant two-view loop, utils/train_one_epoch.py:117-181, over
the 'contrastive' factory branch, model/vit.py:301-337): a
`VisionTransformer3DContrastive` (ViT trunk at the train config's patch
size with global pooling, the predictor and optionally the projector)
trained on the whole SSL pool with loss = -(cos(p1, z2).mean() +
cos(p2, z1).mean()) / 2, the model called as model(original, augmented)
(train_one_epoch.py:142-144); optax's `adamw(b1=0.9, b2=0.95)` without a
decay mask, so every parameter decays, biases and norms included; the
per-update warmup-cosine learning rate at `lr`, else blr * batch_size *
accum_iter / 256 (`accum_iter` scales the rate only: the step never
accumulates, as in JAX); at the end of each epoch a non-finite mean loss
aborts, the min-loss weights are kept and a JSON-lines row is written.

Files: `log.txt` in the work dir ({"train_loss", "epoch"} per epoch) and
`checkpoints/checkpoint-min_loss.pth`, the model's state dict (`trunk.*`,
`heads.*`, the heads' BatchNorm statistics included), where the JAX
package writes an orbax directory `checkpoints/checkpoint-min_loss` of
the params and batch_stats. The init is the port's own draw of JAX's
distributions (`VisionTransformer3DContrastive.init_weights`) from a
`torch.Generator` seeded with the train config's seed.

Data parallelism: `n_devices` > 1 runs on that many ranks, each under a
mesh of (n_devices, 1), as the JAX step's `P('data')` shardings do
(`contrastive.py:66-75` there): each rank trains on its rows of the
one-process batches, the heads' BatchNorm takes the global batch's
moments (`FlaxBatchNorm`), the gradients and the loss are averaged over
the 'data' group, and the group's first rank takes the work-dir lock and
writes every file.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig, ViTConfig
from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import cuda_prefetch
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models.vit import VisionTransformer3DContrastive
from vit_ae_plus_plus_torch.ops.losses import negative_cosine_loss
from vit_ae_plus_plus_torch.parallel import data_parallel
from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import requested_devices
from vit_ae_plus_plus_torch.train import warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import save_state_dict
from vit_ae_plus_plus_torch.train.metrics import Discard, JsonlLogger
from vit_ae_plus_plus_torch.train.optim import AdamW, decay_everything
from vit_ae_plus_plus_torch.train.step import agree_over_model, average_grads, data_mean
from vit_ae_plus_plus_torch.utils.locking import locked_workdir


@dataclasses.dataclass
class ContrastiveState:
    """The model (parameters and the heads' BatchNorm statistics), its
    unmasked AdamW and the step count."""

    model: nn.Module
    tx: AdamW
    step: int = 0


def make_contrastive_step(model: nn.Module):
    """`step(state, original, augmented) -> (state, {"loss"})`: the model in
    training mode on both views, the negative cosine loss, its gradients
    and the AdamW update. Takes tensors on the model's device; the loss
    stays there. Under a `parallel.set_mesh` mesh of (D, M) the views are
    the rows of this rank's data coordinate in the global batch, the heads'
    BatchNorm moments, the gradients (before the update) and the loss are
    the 'data' group's, and the M ranks of a 'model' group repeat their
    coordinate's work, as the 'model' axis replicates the JAX step, and
    take their group's first rank's gradients (train/step.py
    `agree_over_model`)."""

    def step(state: ContrastiveState, original: torch.Tensor, augmented: torch.Tensor):
        m = state.model
        m.train()
        loss = negative_cosine_loss(*m(original, augmented))
        for p in state.tx.params:
            p.grad = None
        loss.backward()
        average_grads(state.tx.params)
        agree_over_model(state.tx.params)
        state.tx.step()
        state.step += 1
        return state, data_mean({"loss": loss.detach()})

    return step


def train_epoch(step, state: ContrastiveState, loader: Loader, device: torch.device):
    """One epoch over `loader`, the views copied to the card ahead of the
    step, the model called as model(original, augmented) (the reference's
    order, train_one_epoch.py:142). -> (state, the mean of the steps'
    losses, fetched from the card once; NaN for an epoch without a step)."""
    losses = []
    for aug, orig, _ in cuda_prefetch(loader, size=2, device=device):
        state, metrics = step(state, orig, aug)
        losses.append(metrics["loss"])
    return state, float(np.mean(torch.stack(losses).tolist())) if losses else float("nan")


@locked_workdir  # refuse a second live writer (utils/locking.py)
def contrastive_train(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    use_proj: bool = False,
    epochs: Optional[int] = None,
    vit_overrides: Optional[Dict] = None,
    n_devices: Optional[int] = None,
    device=None,
) -> Dict:
    """Train a `VisionTransformer3DContrastive` on (original, augmented)
    pairs of the whole SSL pool -> {"min_loss", "checkpoint"}. Runs on
    `cuda` unless `device` names another device, and raises when CUDA is
    asked for and absent. `n_devices` > 1: one of that many ranks (module
    docstring)."""
    d, size = data_parallel(requested_devices(train_cfg, n_devices), "contrastive-train")
    dev = resolve_device(device)
    epochs = epochs if epochs is not None else train_cfg.epochs
    dataset = get_dataset(data_cfg.name, "whole", data_cfg, transforms=default_ssl_transforms(),
                          use_z_score=data_cfg.use_z_score)
    cfg = ViTConfig(volume_size=data_cfg.volume_size, in_chans=data_cfg.in_channels,
                    patch_size=train_cfg.patch_size, num_classes=data_cfg.num_classes, global_pool=True,
                    dtype=train_cfg.compute_dtype, **(vit_overrides or {}))
    model = VisionTransformer3DContrastive(cfg, use_proj=use_proj)
    model.init_weights(torch.Generator().manual_seed(train_cfg.seed)).to(dev)

    loader = Loader(dataset, train_cfg.batch_size, shuffle=True, drop_last=True, seed=train_cfg.seed,
                    shard_rows=(d, size) if size > 1 else None)
    eff_batch = train_cfg.batch_size * train_cfg.accum_iter
    lr = train_cfg.lr if train_cfg.lr is not None else train_cfg.blr * eff_batch / 256
    sched = warmup_cosine_schedule(lr, train_cfg.min_lr, train_cfg.warmup_epochs, epochs, len(loader))
    tx = AdamW(model, sched, train_cfg.weight_decay, b1=0.9, b2=0.95, decay_mask=decay_everything)
    state = ContrastiveState(model=model, tx=tx)
    step = make_contrastive_step(model)
    jsonl = JsonlLogger(work_dir) if d == 0 else Discard()
    ckpt_path = os.path.join(work_dir, "checkpoints", "checkpoint-min_loss.pth")

    min_loss = float("inf")
    for epoch in range(epochs):
        state, mean_loss = train_epoch(step, state, loader, dev)
        if not math.isfinite(mean_loss):
            raise FloatingPointError(f"Loss is {mean_loss}, stopping training")
        if mean_loss < min_loss:  # the group's mean loss: every rank keeps the same best
            min_loss = mean_loss
            if d == 0:
                save_state_dict(ckpt_path, model.state_dict())
        jsonl.write({"train_loss": mean_loss, "epoch": epoch})
    return {"min_loss": min_loss, "checkpoint": ckpt_path}
