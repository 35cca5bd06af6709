"""K-fold linear probe / fine-tune pipeline.

The port's counterpart of the JAX package's pipelines/probe_kfold.py
(reference k_fold_training_scripts/k_fold_cross_valid_linear_projection.py:
105-388 and post_training_utils/fine_tune_epoch.py:216-443): per fold, an
80/20 train/val split (random_state 42, disjointness asserted); that fold's
pretrained MAE encoder (`pretrain_dir/checkpoints/fold_k/
checkpoint-min_loss.pth`, as the port's `pretrain-kfold` writes it) grafted
into a classifier ViT with the head re-initialised; the frozen backbone
with SGD and MixUp3D (probe) or layer-wise AdamW (fine-tune); best models by
three validation criteria; the final test evaluation of each.

With `train_cfg.resume`, each epoch ends by writing the fold's resume
checkpoint `checkpoints/resume_fold_k.pth` (`torch.save`, where the JAX
package writes an orbax directory): the weights, the optimizer's state and
update count, the step, the epoch and the tracker's bests, so a resumed
fold neither repeats an epoch nor overwrites a better best model.

`n_devices` > 1 runs on that many ranks as pipelines/finetune.py says: the
loaders' rows split over the 'data' group, the group's first rank writes
the fold index files (the others read them), the best models, logs and
resume files, and every rank reads the same resume file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import all_labels
from vit_ae_plus_plus_torch.data.splits import kfold_indices, sanity_check_disjoint, train_test_split
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.parallel import barrier, get_mesh, writer_first
from vit_ae_plus_plus_torch.pipelines.finetune import (
    BestModelTracker,
    build_classifier,
    check_supported,
    evaluate,
    log_epoch,
    make_supervised_steps,
    make_tx,
    train_one_epoch,
)
from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import MIN_LOSS_CHECKPOINT
from vit_ae_plus_plus_torch.train import create_train_state, warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, save_atomic
from vit_ae_plus_plus_torch.train.metrics import Discard, JsonlLogger, TBWriter
from vit_ae_plus_plus_torch.utils.locking import locked_workdir


def _resume_payload(state, tracker: BestModelTracker, epoch: int) -> Dict:
    return {
        "model": state.model.state_dict(),
        "optimizer": state.tx.opt.state_dict(),
        "count": state.tx.count,
        "step": state.step,
        "epoch": int(epoch),
        "bests": {c: float(tracker.best[c]) for c in tracker.criteria},
    }


@locked_workdir  # refuse a second live writer (utils/locking.py)
def probe_kfold(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    pretrain_dir: str,
    model_name: str = "contr_mae_vit_base_patch16",
    n_splits: int = 3,
    fix_backbone: bool = True,
    use_mixup: bool = False,
    class_weights: Optional[np.ndarray] = None,
    blr: float = 1e-3,  # reference linear_projection.py:63 default
    layer_decay: float = 0.75,
    folds=None,
    epochs: Optional[int] = None,
    eval_only: bool = False,
    n_devices: Optional[int] = None,
    device=None,
) -> Dict:
    """Returns per-fold test stats for each best-model criterion.

    eval_only skips training and evaluates the saved best checkpoints
    (reference linear_projection.py:197-207 / fine_tune_epoch.py:304-311).
    Runs on `cuda` unless `device` names another device, and raises when
    CUDA is asked for and absent."""
    command = "probe-kfold" if fix_backbone else "finetune-kfold"
    d, size = check_supported(train_cfg, n_devices, command)
    shard, writer = (d, size) if size > 1 else None, d == 0
    dev = resolve_device(device)
    epochs = epochs if epochs is not None else train_cfg.epochs
    dataset_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=default_ssl_transforms(),
                              use_z_score=data_cfg.use_z_score)
    dataset_no_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None,
                                 use_z_score=data_cfg.use_z_score)
    labels = all_labels(dataset_aug)
    fold_list = folds if folds is not None else writer_first(lambda: kfold_indices(
        labels, n_splits, index_dir=os.path.join(work_dir, "k_fold", "indices_file")
    ))
    jsonl = JsonlLogger(work_dir) if writer else Discard()
    batch = train_cfg.batch_size

    results = {}
    for fold_idx, (train_ids, test_ids) in enumerate(fold_list):
        # 80/20 val split with disjointness assert (linear_projection.py:156-160)
        train_ids, val_ids = train_test_split(train_ids, test_size=0.20, random_state=42)
        assert sanity_check_disjoint(train_ids, val_ids, test_ids)

        # the fold's pretrained encoder in a classifier ViT (the preset's
        # patch size, as in the JAX package), head re-initialised
        ckpt = os.path.join(pretrain_dir, "checkpoints", f"fold_{fold_idx}", MIN_LOSS_CHECKPOINT)
        vit_cfg, model = build_classifier(data_cfg, train_cfg, model_name, ckpt, dev)

        loader = Loader(dataset_aug, batch, indices=train_ids, shuffle=True, drop_last=True,
                        seed=train_cfg.seed, shard_rows=shard)
        eff_batch = batch * train_cfg.accum_iter
        lr = train_cfg.lr if train_cfg.lr is not None else blr * eff_batch / 256
        sched = warmup_cosine_schedule(lr, train_cfg.min_lr, train_cfg.warmup_epochs, epochs,
                                       max(len(loader), 1))
        state = create_train_state(model, make_tx(vit_cfg, train_cfg, sched, fix_backbone, layer_decay))
        # the linear-projection reference uses its own MixUp3D here, not the
        # timm Mixup of the fine-tune script (linear_projection.py:31-45)
        train_step, eval_step = make_supervised_steps(
            model, num_classes=data_cfg.num_classes, class_weights=class_weights,
            use_mixup=use_mixup, mixup_impl="reference",
        )

        tracker = BestModelTracker(os.path.join(work_dir, "checkpoints"), write=writer)
        rng = train_cfg.seed + fold_idx
        start_epoch = 0
        resume_on = train_cfg.resume and not eval_only
        resume_path = os.path.join(work_dir, "checkpoints", f"resume_fold_{fold_idx}.pth")
        if resume_on and os.path.exists(resume_path):
            payload = torch.load(resume_path, map_location="cpu", weights_only=True)
            model.load_state_dict(payload["model"], strict=True)
            state.tx.opt.load_state_dict(payload["optimizer"])
            state.tx.count, state.step = payload["count"], payload["step"]
            start_epoch = payload["epoch"] + 1
            tracker.best = dict(payload["bests"])
            loader.set_epoch(start_epoch)
            print(f"Probe fold {fold_idx}: resumed at epoch {start_epoch} (bests {tracker.best})")
        val_loader = Loader(dataset_no_aug, batch, indices=val_ids, shuffle=False, drop_last=False,
                            shard_rows=shard)
        # the probe reference logs the same train_ft/val_ft TensorBoard
        # channels as fine-tune AND evaluates the train split per epoch
        # (linear_projection.py:212-213,302-303,321-324)
        tb_train, tb_val = (TBWriter(os.path.join(work_dir, "logs", f"fold_{fold_idx}", channel)) if writer
                            else Discard() for channel in ("train_ft", "val_ft"))
        train_eval_loader = Loader(dataset_no_aug, batch, indices=train_ids, shuffle=False, drop_last=False,
                                   shard_rows=shard)
        try:
            for epoch in range(start_epoch, 0 if eval_only else epochs):
                state, _ = train_one_epoch(train_step, state, loader, rng, sched, epoch, tb_train,
                                           f"Probe fold {fold_idx} Epoch [{epoch}]", dev)
                train_stats = evaluate(eval_step, train_eval_loader, batch, dev)
                val_stats = evaluate(eval_step, val_loader, batch, dev)
                tracker.update(val_stats, model, fold=fold_idx)
                log_epoch(tb_train, tb_val, train_stats, val_stats, epoch)
                jsonl.write({**{f"train_val_{k}": v for k, v in train_stats.items()},
                             **{f"val_{k}": v for k, v in val_stats.items()},
                             "epoch": epoch, "fold": fold_idx})
                if resume_on and writer:
                    save_atomic(_resume_payload(state, tracker, epoch), resume_path)
        finally:
            tb_train.close()
            tb_val.close()

        # final test evaluation of the three best checkpoints, which the
        # group's first rank has written
        barrier(get_mesh())
        test_loader = Loader(dataset_no_aug, batch, indices=test_ids, shuffle=False, drop_last=False,
                             shard_rows=shard)
        fold_result = {}
        for name in tracker.names:
            path = tracker.path(name, fold_idx)
            if os.path.exists(path):
                model.load_state_dict(load_reference_state_dict(path), strict=True)
                fold_result[name] = evaluate(eval_step, test_loader, batch, dev)
        results[fold_idx] = fold_result
    return results
