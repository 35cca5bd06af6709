"""MoCo-v3 k-fold pretraining and feature extraction baseline.

The port's counterpart of the JAX package's pipelines/moco_kfold.py
(reference other_baselines/mocov3/main_3d_moco_k_fold.py:130-546):
stratified k folds with persisted indices; per fold, from the same seeded
init, two independently augmented views of each volume, LARS (lr =
0.6 * batch / 256, weight decay 1e-6) under the per-iteration warmup(10) +
cosine schedule, the cosine MoCo momentum 0.99 -> 1, the min-loss
checkpoint, then trunk features of the fold's train and test volumes from
the saved min-loss weights. `moco_extract` re-extracts features from
existing checkpoints.

The step runs in this order (JAX `make_moco_train_step`): the momentum
encoder's parameters move toward the pre-step base parameters with this
iteration's m; the base encoder runs x1 then x2 in training mode; the key
passes run on batch statistics without gradients, and their updates of the
momentum encoder's running statistics are discarded; the loss, its
gradients and the LARS update; last, the momentum encoder's running
statistics move toward the base encoder's new ones with m.

Files: `checkpoints/fold_k/checkpoint-min_loss.pth`, the base model's
reference-layout state dict (`base_encoder.*`, its projector at
`base_encoder.head.*` or `base_encoder.fc.*`, `predictor.*`), and
`checkpoints/fold_k/resume-state.pth` (`torch.save`: both encoders with
their BatchNorm statistics, the LARS traces and count, step, epoch and
best loss), where the JAX package writes orbax directories of those names;
`log.txt` in the work dir; `ssl_features_dir/`. The init is the port's own
draw of JAX's distributions from a `torch.Generator` seeded with the
train config's seed, the same for every fold.

Data parallelism: `n_devices` > 1 runs on that many ranks, each under a
mesh of (n_devices, 1) (the CLI's `--n-devices` launches them; the JAX
package's data mesh). `batch_size` stays the global batch and the
learning rate's; each rank loads and trains on its rows of the
one-process run's batches (`Loader(shard_rows=...)`), the loss takes the
global batch's keys and BatchNorm moments (models/moco.py), and the step
averages the gradients and the loss over the group, so every rank applies
the same LARS update and keeps the same EMA. The group's first rank alone
takes the work-dir lock and writes: the fold index files (which the others
then read), `log.txt`, the min-loss `.pth`, the resume state and the
features; every rank reads the resume state, and after a barrier the
min-loss `.pth`, from which the ranks extract their rows of each batch
and gather them in the one-process order.

FSDP (`fsdp`, the CLI's `--fsdp`, JAX moco_kfold.py:180-194, 242-248
there): on the data mesh of `n_devices` > 1, the base and momentum
encoders' leaves and the LARS traces are sharded over 'data'
(parallel/fsdp.py `shard_moco_state_fsdp`), the EMA runs on the blocks,
and the BatchNorm statistics stay replicated. As in the JAX package it
needs a data mesh and a batch that the data size divides, and takes the
ViT trunk only. The checkpoints are written whole (every rank gathers)
and the extraction runs on an unsharded copy of the model.

Refused before any data is read: a mesh with a model axis (the pipelines
run on the data mesh of `n_devices`).
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
from vit_ae_plus_plus_torch.data.loader import all_labels, cuda_prefetch
from vit_ae_plus_plus_torch.data.splits import kfold_indices
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models.moco import MoCoResNet3D, MoCoViT3D, ema_update, moco_loss
from vit_ae_plus_plus_torch.models.resnet3d import conv_precision
from vit_ae_plus_plus_torch.parallel import barrier, data_coords, data_parallel, get_mesh, writer_first
from vit_ae_plus_plus_torch.parallel import fsdp as sharding
from vit_ae_plus_plus_torch.pipelines.extract_features import loader_features
from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import requested_devices
from vit_ae_plus_plus_torch.train import warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import save_atomic, save_state_dict
from vit_ae_plus_plus_torch.train.metrics import Discard, JsonlLogger
from vit_ae_plus_plus_torch.train.step import agree_over_model, average_grads, data_mean
from vit_ae_plus_plus_torch.train.optim import LARS, make_lars
from vit_ae_plus_plus_torch.utils.locking import locked_workdir


@dataclasses.dataclass
class MoCoState:
    """The base model (parameters and BatchNorm statistics), the momentum
    encoder (likewise), the LARS optimizer and the step count."""

    model: nn.Module
    momentum_encoder: nn.Module
    tx: LARS
    step: int = 0


def create_moco_state(model: nn.Module, tx) -> MoCoState:
    """A built (and loaded or initialised) MoCo model, its momentum encoder
    as a copy of the base encoder, and the optimizer from `tx`
    (`make_lars(...)`)."""
    return MoCoState(model=model, momentum_encoder=model.momentum_encoder(), tx=tx(model))


def adjust_moco_momentum(epoch_frac: float, moco_m: float, epochs: int) -> float:
    """Cosine momentum schedule (main_3d_moco_k_fold.py:539-542)."""
    return 1.0 - 0.5 * (1.0 + math.cos(math.pi * epoch_frac / epochs)) * (1.0 - moco_m)


class TwoCropsDataset:
    """Two independently augmented views of each item (TwoCropsTransform,
    moco/loader.py:13-21): __getitem__ -> (view1, view2, label). Each access
    of the underlying dataset draws its augmentation from [seed, item,
    access count], so the two accesses, view 1 first, draw different ones."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        v1, _, label = self.dataset[item]
        v2, _, _ = self.dataset[item]
        return v1, v2, label

    def count_access(self, item: int, n: int = 1) -> None:
        """Count `n` accesses of `item` without loading it, two of the
        underlying dataset's each (a row-sharded loader counts the other
        ranks' rows: data/loader.py)."""
        if hasattr(self.dataset, "count_access"):
            self.dataset.count_access(item, 2 * n)


def _batch_stats(module: nn.Module) -> list:
    return [b for n, b in module.named_buffers() if n.endswith(("running_mean", "running_var"))]


def make_moco_train_step(model: nn.Module, temperature: float = 1.0):
    """`train_step(state, x1, x2, m) -> (state, {"loss"})`: one MoCo update
    in the order the module docstring gives. Takes tensors on the model's
    device; the loss stays there. Under a `parallel.set_mesh` mesh of
    (D, M), x1 and x2 are the rows of this rank's data coordinate in the
    global batch; the keys (`all_gather_batch`), the BatchNorm moments, the
    gradients (before LARS) and the loss are the 'data' group's, and the M
    ranks of a 'model' group repeat their coordinate's work, as the 'model'
    axis replicates the JAX step, and take their group's first rank's
    gradients (train/step.py `agree_over_model`). After
    `parallel.fsdp.shard_moco_state_fsdp` on (D, M > 1) the ViT trunks'
    blocks are also cut over 'model' (JAX's TP rule, which its FSDP
    placement extends). The backward runs under `conv_precision`, as the
    forward of the ResNet trunk does: f32 convolutions without TF32."""

    def train_step(state: MoCoState, x1: torch.Tensor, x2: torch.Tensor, m: float):
        mom = state.momentum_encoder
        ema_update(list(mom.parameters()), list(state.model.base_encoder.parameters()), m)
        mom_stats = _batch_stats(mom)
        kept = [b.clone() for b in mom_stats]
        loss = moco_loss(state.model, mom, x1, x2, temperature)
        for p in state.tx.params:
            p.grad = None
        with conv_precision():
            loss.backward()
        average_grads(state.tx.params, state.tx.shard_axes)
        agree_over_model(state.tx.params, state.tx.shard_axes)
        state.tx.step()
        with torch.no_grad():
            torch._foreach_copy_(mom_stats, kept)
        ema_update(mom_stats, _batch_stats(state.model.base_encoder), m)
        state.step += 1
        return state, data_mean({"loss": loss.detach()})

    return train_step


def build_moco_model(
    data_cfg: DataConfig,
    compute_dtype: str = "float32",
    arch: str = "vit",
    resnet_depth: int = 10,
    moco_dim: int = 256,
    moco_mlp_dim: int = 4096,
    vit_overrides: Optional[Dict] = None,
) -> nn.Module:
    """The MoCo model for either trunk (builder.py:101-124); the ViT is
    `ViTConfig`'s (ViT-B, patch 8) at the data's volume size unless
    `vit_overrides` says otherwise."""
    if arch == "resnet":
        return MoCoResNet3D(depth=resnet_depth, dim=moco_dim, mlp_dim=moco_mlp_dim, dtype=compute_dtype,
                            in_channels=data_cfg.in_channels)
    if arch != "vit":
        raise ValueError(f"arch must be 'vit' or 'resnet', got {arch!r}")
    vit_cfg = ViTConfig(volume_size=data_cfg.volume_size, in_chans=data_cfg.in_channels, num_classes=0,
                        global_pool=False, dtype=compute_dtype, **(vit_overrides or {}))
    return MoCoViT3D(vit_cfg, dim=moco_dim, mlp_dim=moco_mlp_dim)


def check_supported(train_cfg: TrainConfig, n_devices: Optional[int] = None, fsdp: bool = False,
                    arch: str = "vit"):
    """Raise `ValueError` for an FSDP setting that the JAX package refuses
    (no data mesh, a batch the data size does not divide, the ResNet
    trunk), and when the ambient mesh is not the data mesh of `n_devices`
    (`parallel.data_parallel`). -> (d, D) on the 'data' axis."""
    devices = requested_devices(train_cfg, n_devices)
    if fsdp or train_cfg.fsdp:
        if devices is None or devices <= 1:
            raise ValueError("--fsdp needs a data mesh (--n-devices > 1)")
        if train_cfg.batch_size % devices:
            raise ValueError(f"--batch-size {train_cfg.batch_size} must divide by the data mesh ({devices} "
                             "devices) under --fsdp")
        if arch != "vit":
            raise ValueError("--fsdp is implemented for the ViT MoCo trunk; the ResNet trunk is small enough "
                             "to replicate")
    return data_parallel(devices, "moco-kfold")


def min_loss_path(work_dir: str, fold_idx: int) -> str:
    return os.path.join(work_dir, "checkpoints", f"fold_{fold_idx}", "checkpoint-min_loss.pth")


def resume_path(work_dir: str, fold_idx: int) -> str:
    return os.path.join(work_dir, "checkpoints", f"fold_{fold_idx}", "resume-state.pth")


def save_resume(path: str, state: MoCoState, epoch: int, min_loss: float) -> None:
    """The resume state, whole: every rank of the 'data' group calls it (on
    a sharded state the gathers are collective) and its first rank
    writes."""
    payload = {
        "model": sharding.full_state_dict(state.model),
        "momentum_encoder": sharding.full_state_dict(state.momentum_encoder),
        "optimizer": sharding.full_optimizer_state(state.tx),
        "count": state.tx.count,
        "step": state.step,
        "epoch": int(epoch),
        "min_loss": float(min_loss),
    }
    if data_coords()[0] == 0:
        save_atomic(payload, path)


def restore_resume(path: str, state: MoCoState):
    """-> (state, the epoch to start at, the best loss so far); whole leaves
    cut to this rank's blocks on a sharded state."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sharding.load_full_state_dict(state.model, payload["model"], strict=True)
    sharding.load_full_state_dict(state.momentum_encoder, payload["momentum_encoder"], strict=True)
    state.tx.opt.load_state_dict(sharding.local_optimizer_state(state.tx, payload["optimizer"]))
    state.tx.count = payload["count"]
    state.step = payload["step"]
    return state, payload["epoch"] + 1, payload["min_loss"]


def train_epoch(train_step, state: MoCoState, loader: Loader, epoch: int, epochs: int, moco_m: float,
                moco_m_cos: bool, device: torch.device):
    """One epoch over `loader`, the views copied to the card ahead of the
    step, m from the cosine schedule at the fractional epoch. -> (state,
    the mean of the steps' losses, fetched from the card once)."""
    losses = []
    for i, (v1, v2, _labels) in enumerate(cuda_prefetch(loader, size=2, device=device)):
        m = adjust_moco_momentum(epoch + i / len(loader), moco_m, epochs) if moco_m_cos else moco_m
        state, metrics = train_step(state, v1, v2, m)
        losses.append(metrics["loss"])
    return state, float(np.mean(torch.stack(losses).tolist()))


@locked_workdir  # refuse a second live writer (utils/locking.py)
def moco_kfold(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    n_splits: int = 3,
    lr: float = 0.6,
    weight_decay: float = 1e-6,
    moco_m: float = 0.99,
    moco_m_cos: bool = True,
    moco_dim: int = 256,
    moco_mlp_dim: int = 4096,
    temperature: float = 1.0,
    warmup_epochs: int = 10,
    epochs: Optional[int] = None,
    folds=None,
    vit_overrides: Optional[Dict] = None,
    arch: str = "vit",
    resnet_depth: int = 10,
    fsdp: bool = False,
    n_devices: Optional[int] = None,
    device=None,
) -> Dict:
    """-> {fold: {"min_loss"}}. Runs on `cuda` unless `device` names another
    device, and raises when CUDA is asked for and absent. `n_devices` > 1:
    one of that many ranks (module docstring)."""
    fsdp_on = fsdp or train_cfg.fsdp
    d, size = check_supported(train_cfg, n_devices, fsdp_on, arch)
    dev = resolve_device(device)
    writer = d == 0
    epochs = epochs if epochs is not None else train_cfg.epochs
    dataset_v1 = get_dataset(data_cfg.name, "whole", data_cfg, transforms=default_ssl_transforms(),
                             use_z_score=data_cfg.use_z_score)
    dataset_no_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None,
                                 use_z_score=data_cfg.use_z_score)
    labels = all_labels(dataset_v1)
    fold_list = folds if folds is not None else writer_first(lambda: kfold_indices(
        labels, n_splits, index_dir=os.path.join(work_dir, "k_fold", "indices_file")
    ))
    jsonl = JsonlLogger(work_dir) if writer else Discard()
    two_crops = TwoCropsDataset(dataset_v1)
    ck_every = max(1, train_cfg.ckpt_every)
    feat_dir = os.path.join(work_dir, "ssl_features_dir")
    shard = (d, size) if size > 1 else None

    results = {}
    for fold_idx, (train_ids, test_ids) in enumerate(fold_list):
        model = build_moco_model(data_cfg, train_cfg.compute_dtype, arch, resnet_depth, moco_dim, moco_mlp_dim,
                                 vit_overrides)
        model.init_weights(torch.Generator().manual_seed(train_cfg.seed))
        model.to(dev)
        # a global per-epoch reshuffle; under a data mesh, this rank's rows
        # of each global batch
        loader = Loader(two_crops, train_cfg.batch_size, indices=train_ids, shuffle=True, drop_last=True,
                        seed=train_cfg.seed, shard_rows=shard)
        actual_lr = lr * train_cfg.batch_size / 256  # the global batch, as JAX
        sched = warmup_cosine_schedule(actual_lr, 0.0, warmup_epochs, epochs, len(loader))
        state = create_moco_state(model, make_lars(sched, weight_decay=weight_decay))
        if fsdp_on:
            state, _ = sharding.shard_moco_state_fsdp(state, get_mesh())
            print(f"Fold {fold_idx}: MoCo FSDP over data={size} (both encoders + LARS moments "
                  f"1/{size}-sharded)")
        train_step = make_moco_train_step(model, temperature)

        ckpt, resume = min_loss_path(work_dir, fold_idx), resume_path(work_dir, fold_idx)
        min_loss, start_epoch = float("inf"), 0
        # the best weights as device copies (LARS updates the live tensors
        # in place), written on the `ckpt_every` cadence with the resume state
        best, best_dirty = None, False
        if train_cfg.resume and os.path.exists(resume):
            state, start_epoch, min_loss = restore_resume(resume, state)
            loader.set_epoch(start_epoch)  # resume the shuffle schedule too
            print(f"Fold {fold_idx}: resumed at epoch {start_epoch} (min loss so far {min_loss:.4f})")
        for epoch in range(start_epoch, epochs):
            state, mean_loss = train_epoch(train_step, state, loader, epoch, epochs, moco_m, moco_m_cos, dev)
            if mean_loss < min_loss:  # the group's mean loss: every rank keeps the same best
                min_loss = mean_loss
                # parameters and BatchNorm statistics, as the reference saves
                # and reloads (main_3d_moco_k_fold.py:261-268, 295-322)
                best = {k: v.detach().clone() for k, v in model.state_dict().items()}  # this rank's blocks
                best_dirty = True
            jsonl.write({"train_loss": mean_loss, "epoch": epoch, "fold": fold_idx})
            if epoch % ck_every == ck_every - 1 or epoch == epochs - 1:
                # every rank gathers a sharded state; the writer writes
                if best_dirty:
                    whole = sharding.full_state_dict(model, best)
                    if writer:
                        save_state_dict(ckpt, whole)
                    best_dirty = False
                save_resume(resume, state, epoch, min_loss)
        results[fold_idx] = {"min_loss": min_loss}

        # features from the saved min-loss weights, as the reference reloads
        # min_loss.pth.tar before extracting (main_3d_moco_k_fold.py:295-322);
        # the first rank wrote them. A sharded model gives way to a whole one.
        barrier(get_mesh())
        if fsdp_on:
            model = build_moco_model(data_cfg, train_cfg.compute_dtype, arch, resnet_depth, moco_dim, moco_mlp_dim,
                                     vit_overrides)
        for tag, ids in (("train", train_ids), ("test", test_ids)):
            extract_moco_features(model, ckpt, dataset_no_aug, np.sort(ids), train_cfg.batch_size, feat_dir, tag,
                                  fold_idx, device=dev)
    return results


def extract_moco_features(
    model: nn.Module,
    checkpoint_path: str,
    dataset,
    ids,
    batch_size: int,
    out_dir: str,
    tag: str,
    fold_idx: int,
    device=None,
) -> str:
    """Trunk-only features (eval mode) of `ids` from a saved MoCo checkpoint
    loaded into `model` (reference main_extract_ssl_features.py:100-284):
    `{tag}_contrast_ssl_features_split_{fold}.npy` (f32) and its labels
    file; the last partial batch is padded with its first volume. Under a
    data mesh each rank runs its rows of each batch, and the first rank
    writes the gathered features. -> the features' path."""
    dev = resolve_device(device)
    model.load_state_dict(torch.load(checkpoint_path, map_location="cpu", weights_only=True), strict=True)
    model.to(dev)
    d, size = data_coords()
    loader = Loader(dataset, batch_size, indices=ids, shuffle=False, drop_last=False,
                    shard_rows=(d, size) if size > 1 else None)
    feats, labels = loader_features(model.base_encoder, loader, batch_size, dev)
    feat_path = os.path.join(out_dir, f"{tag}_contrast_ssl_features_split_{fold_idx}.npy")
    if d == 0:
        os.makedirs(out_dir, exist_ok=True)
        np.save(feat_path, feats)
        np.save(os.path.join(out_dir, f"{tag}_contrast_ssl_labels_split_{fold_idx}.npy"), labels)
    return feat_path


def moco_extract(
    data_cfg: DataConfig,
    checkpoint: str,
    work_dir: str,
    batch_size: int = 4,
    arch: str = "vit",
    resnet_depth: int = 10,
    moco_dim: int = 256,
    moco_mlp_dim: int = 4096,
    n_splits: int = 3,
    fold_idx: Optional[int] = None,
    compute_dtype: str = "float32",
    vit_overrides: Optional[Dict] = None,
    device=None,
) -> Dict:
    """Re-extract features from existing MoCo checkpoints without training
    (reference main_extract_ssl_features.py:100-284). `checkpoint` a work dir
    of `moco_kfold`: every fold's min-loss checkpoint over its persisted
    folds (only `fold_idx` if given); else one checkpoint `.pth`: the whole
    dataset under the tag `whole`. Runs on `cuda` unless `device` names
    another device."""
    dev = resolve_device(device)
    model = build_moco_model(data_cfg, compute_dtype, arch, resnet_depth, moco_dim, moco_mlp_dim, vit_overrides)
    dataset = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None, use_z_score=data_cfg.use_z_score)
    out_dir = os.path.join(work_dir, "ssl_features_dir")
    results = {}
    if os.path.isdir(os.path.join(checkpoint, "checkpoints")):
        fold_list = kfold_indices(all_labels(dataset), n_splits,
                                  index_dir=os.path.join(checkpoint, "k_fold", "indices_file"))
        for idx, (train_ids, test_ids) in enumerate(fold_list):
            if fold_idx is not None and idx != fold_idx:
                continue
            for tag, ids in (("train", train_ids), ("test", test_ids)):
                results[f"fold{idx}_{tag}"] = extract_moco_features(
                    model, min_loss_path(checkpoint, idx), dataset, np.sort(ids), batch_size, out_dir, tag, idx,
                    device=dev)
    else:
        results["whole"] = extract_moco_features(model, checkpoint, dataset, np.arange(len(dataset)), batch_size,
                                                 out_dir, "whole", fold_idx or 0, device=dev)
    return results
