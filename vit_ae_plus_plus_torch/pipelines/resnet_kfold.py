"""Supervised 3D-ResNet k-fold baseline.

The port's counterpart of the JAX package's pipelines/resnet_kfold.py
(reference k_fold_training_scripts/train_3d_resnet.py:216-330): stratified
k-fold training of a 3D ResNet (depth 10 by default) from a fresh init each
fold, Adam under the per-iteration warmup-cosine schedule (lr 1e-4,
min_lr 1e-6, warmup 5 epochs, fractional epoch step / len(loader)), class
weights (3, 1), the final partial batch trained at its true size, each
epoch's test-fold evaluation as a `log.txt` row, the best model by test
ROC per fold, and an eval-only mode that reads the best models back.

The best models are written as the reference-layout state dict
`checkpoints/best_ft_model_split{k}.pth` (`torch.save` of CPU tensors;
the JAX package writes an orbax directory of that name). The init is the
port's own draw of JAX's distributions (models/resnet3d.py
`init_weights`), from a `torch.Generator` seeded with the train config's
seed: the same weights start every fold, as JAX's `PRNGKey(seed)` does.
The steps run the convolutions under `conv_precision()`, forward and
backward, so cuDNN never takes TF32 for the f32 model.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import all_labels, cuda_prefetch
from vit_ae_plus_plus_torch.data.splits import kfold_indices
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models.resnet3d import conv_precision, generate_model
from vit_ae_plus_plus_torch.ops import weighted_ce
from vit_ae_plus_plus_torch.pipelines.finetune import evaluate
from vit_ae_plus_plus_torch.train import create_train_state, warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import save_state_dict
from vit_ae_plus_plus_torch.train.metrics import JsonlLogger
from vit_ae_plus_plus_torch.train.optim import make_adam
from vit_ae_plus_plus_torch.utils.locking import locked_workdir


def best_model_path(work_dir: str, fold_idx: int) -> str:
    return os.path.join(work_dir, "checkpoints", f"best_ft_model_split{fold_idx}.pth")


def make_resnet_tx(lr: float, epochs: int, steps_per_epoch: int, min_lr: float = 1e-6,
                   warmup_epochs: int = 5):
    """Adam (torch defaults: betas 0.9/0.999, eps 1e-8, no weight decay)
    under the reference's per-iteration warmup-cosine learning rate
    (train_3d_resnet.py:262, 47-48 + utils/lr_sched.py:9-21): a recipe."""
    return make_adam(warmup_cosine_schedule(lr, min_lr, warmup_epochs, epochs, steps_per_epoch))


def make_resnet_steps(model: torch.nn.Module, class_weights) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) of the class-weighted CE.

    `train_step(state, batch, labels) -> (state, {"loss"})`: one Adam
    update on the batch statistics, which moves the BatchNorm running
    ones. `eval_step(batch, labels) -> (logits, loss)` in eval mode,
    without gradients. Both take tensors on the model's device; the loss
    stays there."""
    device = next(model.parameters()).device
    cw = torch.as_tensor(np.asarray(class_weights), dtype=torch.float32, device=device)

    def train_step(state, batch: torch.Tensor, labels):
        labels = torch.as_tensor(labels, dtype=torch.int64, device=batch.device)
        state.model.train()
        with conv_precision():
            loss = weighted_ce(state.model(batch), labels, cw)
            for p in state.tx.params:
                p.grad = None
            loss.backward()
        state.tx.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    def eval_step(batch: torch.Tensor, labels):
        labels = torch.as_tensor(labels, dtype=torch.int64, device=batch.device)
        model.eval()
        with torch.inference_mode():
            logits = model(batch)
            return logits, weighted_ce(logits, labels, cw)

    return train_step, eval_step


def train_epoch(train_step, state, loader: Loader, device: torch.device):
    """One epoch of `train_step` over `loader`, batches copied to the card
    ahead of the step; the last batch may be partial. Nothing is fetched
    from the card. -> state."""
    for aug, _orig, labels in cuda_prefetch(loader, size=2, device=device, put_orig=False):
        state, _ = train_step(state, aug, labels)
    return state


def check_supported(n_devices: Optional[int]) -> None:
    if (n_devices or 1) > 1:
        raise NotImplementedError(
            "resnet-kfold: n_devices > 1 (data-parallel training) has no path to port: the JAX package "
            "has no data-parallel ResNet (its CLI passes resnet-kfold no mesh)")


@locked_workdir  # refuse a second live writer (utils/locking.py)
def resnet_kfold(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    depth: int = 10,
    n_splits: int = 3,
    lr: float = 1e-4,
    class_weights=(3.0, 1.0),
    folds=None,
    epochs: Optional[int] = None,
    eval_only: bool = False,
    n_devices: Optional[int] = None,
    device=None,
) -> Dict:
    """-> {fold: {"best_roc"}} after training, {fold: test stats of the best
    model} with `eval_only`. Runs on `cuda` unless `device` names another
    device, and raises when CUDA is asked for and absent."""
    check_supported(n_devices)
    dev = resolve_device(device)
    epochs = epochs if epochs is not None else train_cfg.epochs
    dataset_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=default_ssl_transforms(),
                              use_z_score=data_cfg.use_z_score)
    dataset_no_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None,
                                 use_z_score=data_cfg.use_z_score)
    labels = all_labels(dataset_aug)
    fold_list = folds if folds is not None else kfold_indices(
        labels, n_splits, index_dir=os.path.join(work_dir, "k_fold", "indices_file")
    )
    jsonl = JsonlLogger(work_dir)
    batch = train_cfg.batch_size

    results = {}
    for fold_idx, (train_ids, test_ids) in enumerate(fold_list):
        model = generate_model(depth, n_classes=data_cfg.num_classes, n_input_channels=data_cfg.in_channels,
                               dtype=train_cfg.compute_dtype)
        model.init_weights(torch.Generator().manual_seed(train_cfg.seed))
        model.to(dev)
        loader = Loader(dataset_aug, batch, indices=train_ids, shuffle=True, drop_last=False,
                        seed=train_cfg.seed)
        # per-iteration schedule at fractional epoch = step / len(loader),
        # the reference's data_iter_step / len(data_loader) + epoch
        state = create_train_state(model, make_resnet_tx(lr, epochs, max(len(loader), 1)))
        train_step, eval_step = make_resnet_steps(model, class_weights)
        test_loader = Loader(dataset_no_aug, batch, indices=test_ids, shuffle=False, drop_last=False)
        path = best_model_path(work_dir, fold_idx)
        if eval_only:
            # reference test-only mode (train_3d_resnet.py:314-351): the
            # fold's best model on the fold's test split
            model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
            results[fold_idx] = evaluate(eval_step, test_loader, batch, dev)
            continue
        best_roc = 0.0
        for epoch in range(epochs):
            state = train_epoch(train_step, state, loader, dev)
            test_stats = evaluate(eval_step, test_loader, batch, dev)
            if test_stats["roc_auc_score"] > best_roc:
                best_roc = test_stats["roc_auc_score"]
                save_state_dict(path, model.state_dict())
            jsonl.write({**{f"test_{k}": v for k, v in test_stats.items()}, "epoch": epoch, "fold": fold_idx})
        results[fold_idx] = {"best_roc": best_roc}
    return results
