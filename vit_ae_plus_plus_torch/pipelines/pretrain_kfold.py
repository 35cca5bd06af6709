"""Combined k-fold SSL pretraining + per-fold feature extraction.

The port's counterpart of the JAX package's pipelines/pretrain_kfold.py,
the primary entry point (reference k_fold_cross_valid_combined_brats.py:
77-281, and the EGD variant :79-293):

- stratified k folds (5 BraTS / 3 EGD) with persisted fold indices;
- per fold: contrastive MAE pretraining with the per-epoch edge-weight
  schedule 0.01 * (1 - epoch / epochs), AdamW(0.9, 0.95) with
  lr = blr * eff_batch / 256, per-update warmup-cosine;
- the min-train-loss weights as `checkpoints/fold_k/checkpoint-min_loss.pth`
  (a reference-layout state dict, which `serve --checkpoint` reads), the
  JSON-lines epoch log `checkpoints/log.txt`, TensorBoard scalars under
  `logs/`, and with `resume` a full-state resume checkpoint per fold;
- then: graft the encoder into a plain ViT and dump train/test SSL features
  under `ssl_features_dir/`.

The step's metrics are summed on the device and fetched once an epoch; the
only sync inside an epoch is the NaN check every `nan_check_every` steps
(the reference synchronised every iteration, train_one_epoch.py:76,105).

Not ported yet, and refused before any data is read or any file written:
`device_augment`, `device_data`, the perceptual term and `accum_iter > 1`
(ROADMAP Queue 1 item 4); FSDP, the GPipe pipeline and data parallelism
over more than one device (item 7).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import ConcatDataset, all_labels, cuda_prefetch
from vit_ae_plus_plus_torch.data.splits import kfold_indices
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.pipelines.transfer import mae_params_to_vit
from vit_ae_plus_plus_torch.train import (
    create_train_state,
    make_adamw,
    make_train_step,
    warmup_cosine_schedule,
)
from vit_ae_plus_plus_torch.train.checkpoint import (
    CheckpointManager,
    load_reference_state_dict,
    save_state_dict,
)
from vit_ae_plus_plus_torch.train.metrics import JsonlLogger, MetricLogger, TBWriter
from vit_ae_plus_plus_torch.train.step import feature_step
from vit_ae_plus_plus_torch.utils.locking import locked_workdir

MIN_LOSS_CHECKPOINT = "checkpoint-min_loss.pth"


def check_supported(train_cfg: TrainConfig, n_devices: Optional[int] = None) -> None:
    """Raise `NotImplementedError` for a setting whose path the port does not
    have yet, naming the ROADMAP item that brings it."""
    refused = [
        (train_cfg.device_augment, "device_augment (augmentation on the card)", "item 4"),
        (train_cfg.device_data, "device_data (the whole raw fold resident on the card)", "item 4"),
        (train_cfg.perceptual_weight > 0, "perceptual_weight > 0 (the VGG perceptual term)", "item 4"),
        (train_cfg.accum_iter > 1, "accum_iter > 1 (gradient accumulation)", "item 4"),
        (train_cfg.fsdp, "fsdp (parameters and optimizer state sharded over 'data')", "item 7"),
        ((train_cfg.pipe_devices or 1) > 1, "pipe_devices > 1 (the GPipe pipeline)", "item 7"),
        ((n_devices or 1) > 1 or train_cfg.mesh_shape[0] > 1,
         "n_devices > 1 or a mesh_shape with data > 1 (data-parallel training)", "item 7"),
    ]
    for bad, what, item in refused:
        if bad:
            raise NotImplementedError(
                f"pretrain-kfold: {what} is not ported yet (ROADMAP Queue 1 {item})")


def pretrain_one_fold(
    fold_idx: int,
    train_ids,
    dataset_aug,
    train_cfg: TrainConfig,
    model_name: str,
    data_cfg: DataConfig,
    work_dir: str,
    tb: Optional[TBWriter] = None,
    device=None,
):
    """Train the MAE on one fold -> (mae_cfg, min-loss state dict, stats)."""
    dev = resolve_device(device)
    mae_cfg = MODEL_ZOO[model_name](
        volume_size=data_cfg.volume_size,
        in_chans=data_cfg.in_channels,
        patch_size=train_cfg.patch_size,
        norm_pix_loss=train_cfg.norm_pix_loss,
        dtype=train_cfg.compute_dtype,
        ln_dtype=train_cfg.ln_dtype,
    )
    model = build_model(mae_cfg).init_weights(torch.Generator().manual_seed(train_cfg.seed)).to(dev)
    loader = Loader(
        dataset_aug, train_cfg.batch_size, indices=train_ids,
        shuffle=True, drop_last=True, seed=train_cfg.seed,
        # global per-epoch reshuffle, then a round-robin shard with wrap
        # padding (data/loader.py epoch_shard)
        shard_across_processes=True,
    )
    steps_per_epoch = len(loader)
    eff_batch = train_cfg.batch_size * train_cfg.accum_iter
    lr = train_cfg.lr if train_cfg.lr is not None else train_cfg.blr * eff_batch / 256
    schedule = warmup_cosine_schedule(
        lr, train_cfg.min_lr, train_cfg.warmup_epochs, train_cfg.epochs, steps_per_epoch
    )
    tx = make_adamw(schedule, train_cfg.weight_decay, clip_grad=train_cfg.clip_grad,
                    accum_iter=train_cfg.accum_iter)
    # the masking noise's stream: the JAX package folds the step into
    # PRNGKey(seed + 100 + fold); here the generator's state is saved and
    # restored with the resume checkpoint, so a resumed run draws what an
    # uninterrupted one would
    state = create_train_state(model, tx, seed=train_cfg.seed + 100 + fold_idx)
    step = make_train_step(
        model, mae_cfg.patch_size,
        mask_ratio=train_cfg.mask_ratio,
        contr_weight=train_cfg.contr_weight if mae_cfg.contrastive else 0.0,
        perceptual_weight=train_cfg.perceptual_weight,
        norm_pix_loss=train_cfg.norm_pix_loss,
        loss_filters_dtype=train_cfg.loss_filters_dtype,
    )

    ckpt_dir = os.path.join(work_dir, "checkpoints", f"fold_{fold_idx}")
    min_loss_path = os.path.join(ckpt_dir, MIN_LOSS_CHECKPOINT)
    jsonl = JsonlLogger(os.path.join(work_dir, "checkpoints"))
    min_loss = float("inf")
    # the best weights as device copies (the optimizer updates the live
    # tensors in place), written to disk on the `ckpt_every` cadence
    best, best_dirty = None, False
    ck_every = max(1, train_cfg.ckpt_every)
    t_start = time.time()

    # full-state resume (reference --resume, utils/misc.py:315-329)
    start_epoch = train_cfg.start_epoch
    resume_mgr = None
    if train_cfg.resume:
        resume_dir = os.path.join(ckpt_dir, "resume")
        # the JAX package's guard against restoring a pipeline-parallel
        # layout; the port trains one layout only
        layout_file = os.path.join(resume_dir, "layout.json")
        if os.path.exists(layout_file):
            with open(layout_file) as f:
                have = json.load(f).get("pipe", 1)
            if have != 1:
                raise ValueError(
                    f"resume checkpoints in {resume_dir} were written with --pipe-devices "
                    f"{have}; the port trains with --pipe-devices 1. Start from the "
                    "layout-independent min-loss checkpoint in a fresh work dir."
                )
        else:
            os.makedirs(resume_dir, exist_ok=True)
            with open(layout_file, "w") as f:
                json.dump({"pipe": 1}, f)
        resume_mgr = CheckpointManager(resume_dir)
        state, restored_epoch, restored_min = resume_mgr.restore(state)
        if restored_epoch is not None:
            start_epoch = restored_epoch + 1
            min_loss = restored_min  # keep the pre-crash best
            loader.set_epoch(start_epoch)  # resume the shuffle schedule
            print(f"Resumed fold {fold_idx} at epoch {start_epoch} "
                  f"(min loss so far {min_loss:.4f})")

    for epoch in range(start_epoch, train_cfg.epochs):
        edge_w = 0.01 * (1 - epoch / train_cfg.epochs) if train_cfg.use_edge_map else 0.0
        logger = MetricLogger()
        sums, count = None, 0
        prof = None
        if train_cfg.profile_dir and epoch == start_epoch + 1:
            prof = _start_profile(dev)
        epoch_t0 = time.time()
        batches = cuda_prefetch(loader, size=2, device=dev)
        for aug, orig, _ in logger.log_every(
            batches, header=f"Fold {fold_idx} Epoch [{epoch}]", length=len(loader)
        ):
            state, metrics = step(state, aug, orig, edge_w)
            sums = metrics if sums is None else {k: sums[k] + v for k, v in metrics.items()}
            count += 1
            k = train_cfg.nan_check_every
            if k and count % k == 0:
                # the only sync inside the epoch, once per k steps: stops a
                # diverged run within k steps (the reference checks every
                # step, train_one_epoch.py:66-68)
                step_loss = float(metrics["loss"])
                if not math.isfinite(step_loss):
                    raise FloatingPointError(
                        f"Loss is {step_loss} at fold {fold_idx} epoch {epoch} "
                        f"step {count}, stopping training"
                    )
        names = sorted(sums)  # the JAX package's order (a pytree's sorted keys)
        values = torch.stack([sums[n].double() for n in names]).tolist()  # one fetch
        stats = {n: v / count for n, v in zip(names, values)}
        epoch_time = time.time() - epoch_t0  # the fetch above waited for the card
        stats["volumes_per_sec"] = count * train_cfg.batch_size / epoch_time
        if prof is not None:
            prof.stop()
            os.makedirs(train_cfg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(train_cfg.profile_dir, f"fold_{fold_idx}_epoch_{epoch}.json"))
        stats["lr"] = float(schedule((epoch + 1) * steps_per_epoch - 1))
        logger.update(**stats)
        if tb is not None:
            tb.scalars(
                {
                    "train_loss": stats["loss"],
                    "lr": stats["lr"],
                    "reconstruction_loss": stats["reconstruction_loss"],
                    "sobel_loss": stats["edge_map_loss"],
                    "perceptual_loss": stats["perceptual_loss"],
                    "contr_loss": stats["contr_loss"],
                },
                epoch + 1,
            )
        if not math.isfinite(stats["loss"]):
            raise FloatingPointError(f"Loss is {stats['loss']}, stopping training")
        if stats["loss"] < min_loss:
            min_loss = stats["loss"]
            best = {n: v.detach().clone() for n, v in model.state_dict().items()}
            best_dirty = True
        jsonl.write({**{f"train_{n}": v for n, v in stats.items()}, "epoch": epoch,
                     "fold": fold_idx})
        if epoch % ck_every == ck_every - 1 or epoch == train_cfg.epochs - 1:
            if best_dirty:
                save_state_dict(min_loss_path, best)
                best_dirty = False
            if resume_mgr is not None:
                resume_mgr.save(state, epoch=epoch, min_loss=min_loss)

    if best is None:
        # resumed at (or past) the final epoch, or no resumed epoch beat the
        # restored best: the saved min-loss weights are the fold's best
        if not os.path.exists(min_loss_path):
            raise FileNotFoundError(
                f"no epochs ran for fold {fold_idx} and no min-loss checkpoint "
                f"exists at {min_loss_path} (start_epoch >= epochs on a fresh work dir?)"
            )
        best = load_reference_state_dict(min_loss_path)
    print(f"Fold {fold_idx}: trained epochs [{start_epoch}, {train_cfg.epochs}) in "
          f"{time.time() - t_start:.0f}s, min loss {min_loss:.4f}")
    return mae_cfg, best, {"min_loss": min_loss}


def _start_profile(dev: torch.device):
    """A torch.profiler trace of one epoch (host, and the card's kernels on
    CUDA), exported as Chrome JSON when the epoch ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def extract_fold_features(
    mae_cfg,
    mae_sd: Dict[str, torch.Tensor],
    dataset_no_aug,
    ids,
    batch_size: int,
    out_dir: str,
    tag: str,
    fold_idx: int,
    num_classes: int = 2,
    device=None,
) -> None:
    """Graft the MAE's encoder into a ViT (in the compute dtype), run batched
    `feature_step` over `ids`, save float32 features and the labels as npy
    (reference k_fold_…_brats.py:256-281 + utils/feature_extraction.py:9-45)."""
    dev = resolve_device(device)
    vit_cfg = mae_cfg.encoder_vit_config(num_classes=num_classes, global_pool=True)
    with torch.device("meta"):
        model = build_model(vit_cfg)
    sd = mae_params_to_vit(mae_sd, model.state_dict(), mae_cfg, vit_cfg)
    model = model.to_empty(device=dev)
    model.load_state_dict(sd, strict=True)
    model.eval()

    loader = Loader(
        dataset_no_aug, batch_size, indices=ids, shuffle=False, drop_last=False,
        num_workers=8,
    )
    feats, labels = [], []
    for aug, _orig, lab in cuda_prefetch(loader, size=2, device=dev, put_orig=False):
        n = aug.shape[0]
        if n < batch_size:  # pad the final partial slab with its first volume
            aug = torch.cat([aug, aug[:1].expand(batch_size - n, *aug.shape[1:])])
        feats.append(feature_step(model, aug)[:n])
        labels.append(lab)
    os.makedirs(out_dir, exist_ok=True)
    # float32 on disk whatever the compute dtype: numpy has no bfloat16, and
    # the downstream readers are numpy and scikit-learn
    np.save(os.path.join(out_dir, f"{tag}_contrast_ssl_features_split_{fold_idx}.npy"),
            torch.cat(feats).float().cpu().numpy())
    np.save(os.path.join(out_dir, f"{tag}_contrast_ssl_labels_split_{fold_idx}.npy"),
            np.concatenate(labels))


@locked_workdir  # refuse a second live writer (utils/locking.py)
def pretrain_kfold(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    model_name: str = "contr_mae_vit_base_patch16",
    n_splits: int = 5,
    n_devices: Optional[int] = None,
    folds=None,
    device=None,
) -> Dict:
    """The combined pipeline over all folds -> {fold: {"min_loss": ...}}, or
    {fold: {"skipped": True}} for a fold that `resume` finds complete.
    Runs on `cuda` unless `device` names another device, and raises when
    CUDA is asked for and absent."""
    check_supported(train_cfg, n_devices)
    dev = resolve_device(device)
    transforms = default_ssl_transforms()
    if data_cfg.name == "egd":
        # EGD combined semantics (reference k_fold_…_egd.py:103-137): k-fold
        # over the LABELED pool; pretraining sees labeled-train + the whole
        # unlabeled SSL pool concatenated with offset ids; features come from
        # the labeled pool only
        labeled_aug = get_dataset("egd", "test", data_cfg, transforms=transforms,
                                  use_z_score=data_cfg.use_z_score)
        labeled_no_aug = get_dataset("egd", "test", data_cfg, transforms=None,
                                     use_z_score=data_cfg.use_z_score)
        ssl_aug = get_dataset("egd", "ssl", data_cfg, transforms=transforms,
                              use_z_score=data_cfg.use_z_score)
        dataset_aug = ConcatDataset([labeled_aug, ssl_aug])
        dataset_no_aug = labeled_no_aug
        labels = all_labels(labeled_no_aug)
        ssl_offset_ids = np.arange(len(ssl_aug)) + len(labeled_aug)
    else:
        dataset_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=transforms,
                                  use_z_score=data_cfg.use_z_score)
        dataset_no_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None,
                                     use_z_score=data_cfg.use_z_score)
        labels = all_labels(dataset_no_aug)
        ssl_offset_ids = None
    fold_list = folds if folds is not None else kfold_indices(
        labels, n_splits, index_dir=os.path.join(work_dir, "k_fold", "indices_file")
    )

    tb = TBWriter(os.path.join(work_dir, "logs"))
    results = {}
    feat_dir = os.path.join(work_dir, "ssl_features_dir")
    try:
        for fold_idx, (train_ids, test_ids) in enumerate(fold_list):
            if train_cfg.resume:
                # a fold whose features are on disk is complete (they are
                # written strictly after training and the min-loss checkpoint)
                done = all(
                    os.path.exists(os.path.join(
                        feat_dir, f"{tag}_contrast_ssl_features_split_{fold_idx}.npy"))
                    for tag in ("train", "test")
                )
                if done:
                    print(f"Fold {fold_idx}: features already extracted, skipping")
                    results[fold_idx] = {"skipped": True}
                    continue
            pretrain_ids = (
                np.concatenate([train_ids, ssl_offset_ids])
                if ssl_offset_ids is not None else train_ids
            )
            mae_cfg, best, stats = pretrain_one_fold(
                fold_idx, pretrain_ids, dataset_aug, train_cfg, model_name, data_cfg, work_dir,
                tb=tb, device=dev,
            )
            for tag, ids in (("train", train_ids), ("test", test_ids)):
                extract_fold_features(
                    mae_cfg, best, dataset_no_aug, np.sort(ids), train_cfg.batch_size,
                    feat_dir, tag, fold_idx, num_classes=data_cfg.num_classes, device=dev,
                )
            results[fold_idx] = stats
    finally:
        tb.close()
    return results
