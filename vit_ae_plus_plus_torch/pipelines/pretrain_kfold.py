"""Combined k-fold SSL pretraining + per-fold feature extraction.

The port's counterpart of the JAX package's pipelines/pretrain_kfold.py,
the primary entry point (reference k_fold_cross_valid_combined_brats.py:
77-281, and the EGD variant :79-293):

- stratified k folds (5 BraTS / 3 EGD) with persisted fold indices;
- per fold: contrastive MAE pretraining with the per-epoch edge-weight
  schedule 0.01 * (1 - epoch / epochs), AdamW(0.9, 0.95) with
  lr = blr * eff_batch / 256, eff_batch = batch_size * accum_iter * D on D
  data-parallel ranks, per-update warmup-cosine; with `accum_iter` k > 1
  an update every k steps on the mean of their gradients (optax's
  `MultiSteps`);
- the min-train-loss weights as `checkpoints/fold_k/checkpoint-min_loss.pth`
  (a reference-layout state dict, which `serve --checkpoint` reads), the
  JSON-lines epoch log `checkpoints/log.txt`, TensorBoard scalars under
  `logs/`, and with `resume` a full-state resume checkpoint per fold;
- then: graft the encoder into a plain ViT and dump train/test SSL features
  under `ssl_features_dir/`.

The step's metrics are summed on the device and fetched once an epoch; the
only sync inside an epoch is the NaN check every `nan_check_every` steps
(the reference synchronised every iteration, train_one_epoch.py:76,105).

The options off the default path, wired as the JAX package wires them:
`device_augment` reads raw volumes (BraTS, or EGD's labeled and SSL pools,
per-channel z-scored) and augments and normalises each batch on the card
(ops/augment.py), its draws from a generator seeded by (seed, fold, epoch,
step), as the JAX package folds (key, epoch, step), so a resumed run draws
what an uninterrupted one would; `device_data` (which needs
`device_augment`) holds the fold's raw volumes on the card
(`DeviceResidentBatches`) and its batches skip `cuda_prefetch`;
`perceptual_weight` > 0 adds the VGG16 term (models/vgg.py, weights from
`vgg_ckpt` or seeded), gradient-free as in the reference.

Data parallelism: `n_devices` > 1 runs on that many ranks, each under a
mesh of (n_devices, 1) (the CLI's `--n-devices` launches them; the JAX
package's `make_mesh(data=n_devices)`). `batch_size` stays the global
batch; each rank loads and trains on its rows of the one-process run's
batches (`Loader(shard_rows=...)`), the step averages over the group
(train/step.py), and the extraction gathers the features in the
one-process order. The learning rate's `eff_batch` and the logged
volumes/s count the global batch D times, as the JAX package's do
(pretrain_kfold.py:122, :340-342 there): a quirk kept, so that a run on D
devices learns at the JAX package's rate (ROADMAP Queue 3). The group's
first rank alone takes the work-dir lock and writes: the fold index files
(which the others then read), the min-loss `.pth`, the resume state,
`log.txt`, the TensorBoard events and the features. The others choose the same best state, since the
epoch's loss is the group's mean, and read the same resume file.

FSDP (`fsdp`, the CLI's `--fsdp`, JAX pretrain_kfold.py:196-216 there):
on the data mesh of `n_devices` > 1, the parameters and the AdamW moments
(and `MultiSteps`' running mean) are sharded over 'data'
(parallel/fsdp.py `shard_train_state_fsdp`), each block's leaves gathered
at its use; it needs a data mesh, as in the JAX package. The best weights
are kept as this rank's blocks and gathered, by every rank, when they are
written and for the extraction; the resume checkpoint is written whole,
so a run resumes under either layout.

The GPipe pipeline (`pipe_devices` S > 1, the CLI's `--pipe-devices`,
JAX pretrain_kfold.py:150-193 there): `n_devices` (S by default) ranks
under the ('data', 'pipe') mesh of S stages and n_devices / S data
coordinates (`parallel.make_pipeline_mesh`); each stage holds its blocks
of both stacks and their AdamW moments (parallel/pp.py
`shard_pipeline_state`, the optimizer built in that layout), the step is
`make_pp_train_step` at `pp_microbatches` or
`auto_microbatches(batch, S, data=D)` microbatches, and `fsdp` composes
(the stage's large block leaves also sharded over 'data', which must then
be > 1). The min-loss `.pth` is per-layer and in the reference layout, every
stage's blocks gathered (`pp.full_state_dict`); the resume files are per
stage, `layout.json` records `{"pipe": S}` and another S is refused, as in
the JAX package. The extraction runs the whole best weights on stage 0's
'data' group (JAX's `extract_fold_features` runs unpipelined too). The
mesh's first rank writes every file.

Refused before any data is read or any file written: a mesh with a model
axis, a `--n-devices` that `--pipe-devices` does not divide; `device_data`
without `device_augment` raises `ValueError`, as in the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import BraTSDataset, EGDDataset, Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import ConcatDataset, DeviceResidentBatches, all_labels, cuda_prefetch
from vit_ae_plus_plus_torch.data.splits import kfold_indices
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model, build_perceptual
from vit_ae_plus_plus_torch.ops.augment import device_augment_batch
from vit_ae_plus_plus_torch.parallel import data_coords, data_parallel, get_mesh, is_writer, writer_first
from vit_ae_plus_plus_torch.parallel import fsdp as sharding
from vit_ae_plus_plus_torch.parallel import pp
from vit_ae_plus_plus_torch.pipelines.extract_features import loader_features
from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
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
from vit_ae_plus_plus_torch.train.metrics import Discard, JsonlLogger, MetricLogger, TBWriter
from vit_ae_plus_plus_torch.utils.locking import locked_workdir

MIN_LOSS_CHECKPOINT = "checkpoint-min_loss.pth"


def check_supported(train_cfg: TrainConfig, n_devices: Optional[int] = None) -> Tuple[int, int]:
    """Raise `ValueError` for a setting the JAX package refuses too (FSDP
    without a data axis > 1, a `--n-devices` that `--pipe-devices` does not
    divide) and when the ambient mesh is not the mesh of `n_devices` and
    `pipe_devices` (`parallel.data_parallel`). -> (d, D) on the 'data'
    axis."""
    if train_cfg.device_data and not train_cfg.device_augment:
        raise ValueError("device_data requires device_augment (the raw volumes are normalised on the card)")
    pipe = train_cfg.pipe_devices or 1
    devices = requested_devices(train_cfg, n_devices)
    if train_cfg.fsdp and (devices is None or devices <= 1):
        raise ValueError("--fsdp needs a data mesh (--n-devices > 1)")
    if train_cfg.fsdp and pipe > 1 and devices // pipe <= 1:
        raise ValueError(f"--fsdp with --pipe-devices needs a data axis > 1 (got n_devices={devices}, pipe={pipe})")
    if pipe > 1:
        total = devices if devices is not None else pipe
        if total % pipe:
            raise ValueError(f"--n-devices {total} not divisible by --pipe-devices {pipe}")
        return data_parallel(total // pipe, "pretrain-kfold", pipe=pipe)
    return data_parallel(devices, "pretrain-kfold")


def requested_devices(train_cfg: TrainConfig, n_devices: Optional[int]) -> Optional[int]:
    """The data-parallel device count asked for: `n_devices`, else
    `train_cfg.mesh_shape`'s data size when it is above 1, else None."""
    if n_devices is not None:
        return n_devices
    return train_cfg.mesh_shape[0] if train_cfg.mesh_shape[0] > 1 else None


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
    """Train the MAE on one fold -> (mae_cfg, min-loss state dict, stats).
    Under a data mesh, each rank trains on its rows of the global batches
    and the first rank alone writes (module docstring)."""
    dev = resolve_device(device)
    mesh = get_mesh()
    d, size = data_coords(mesh)
    writer = is_writer(mesh)
    pipe = mesh.size("pipe") if mesh is not None else 1
    ckpt_dir = os.path.join(work_dir, "checkpoints", f"fold_{fold_idx}")
    resume_dir = os.path.join(ckpt_dir, "resume")
    if train_cfg.resume:
        # another layout is refused on every rank before any work, then the
        # writer records this one in a fresh dir
        _check_layout(resume_dir, pipe, write=False)
        writer_first(lambda: _check_layout(resume_dir, pipe, write=writer))
    mae_cfg = MODEL_ZOO[model_name](
        volume_size=data_cfg.volume_size,
        in_chans=data_cfg.in_channels,
        patch_size=train_cfg.patch_size,
        norm_pix_loss=train_cfg.norm_pix_loss,
        dtype=train_cfg.compute_dtype,
        ln_dtype=train_cfg.ln_dtype,
    )
    model = build_model(mae_cfg).init_weights(torch.Generator().manual_seed(train_cfg.seed)).to(dev)
    # under a data mesh, this rank's rows of each global batch
    shard_rows = (d, size) if size > 1 else None
    if train_cfg.device_data:
        # the fold's raw volumes staged on the card once: an epoch copies
        # nothing from the host, a batch is one index_select
        loader = DeviceResidentBatches(dataset_aug, train_cfg.batch_size, indices=train_ids,
                                       seed=train_cfg.seed, device=dev, shard_rows=shard_rows)
        print(f"Fold {fold_idx}: dataset resident on the card ({loader.nbytes() / 1e9:.2f} GB)")
    else:
        # a global per-epoch reshuffle
        loader = Loader(dataset_aug, train_cfg.batch_size, indices=train_ids, shuffle=True, drop_last=True,
                        seed=train_cfg.seed, shard_rows=shard_rows)
    steps_per_epoch = len(loader)
    eff_batch = train_cfg.batch_size * train_cfg.accum_iter * size
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
    if pipe > 1:
        # each stage its blocks and their moments, the optimizer built in
        # that layout (parallel/pp.py); with fsdp the stage's large block
        # leaves also 1/D over 'data'; the min-loss checkpoint stays whole
        state, _ = pp.shard_pipeline_state(state, mesh, data_axis="data" if train_cfg.fsdp else None)
    elif train_cfg.fsdp:
        # the parameters and moments 1/D-sharded (parallel/fsdp.py); the
        # checkpoints stay whole (train/checkpoint.py)
        state, _ = sharding.shard_train_state_fsdp(state, mesh)
        print(f"Fold {fold_idx}: FSDP over data={size} (params+moments 1/{size}-sharded)")
    perceptual_fn = None
    if train_cfg.perceptual_weight:
        # the gradient-free VGG term (reference vit_autoenc.py:229-230)
        _, perceptual_fn = build_perceptual(train_cfg.vgg_ckpt, device=dev)
    step_kw = dict(
        mask_ratio=train_cfg.mask_ratio,
        contr_weight=train_cfg.contr_weight if mae_cfg.contrastive else 0.0,
        perceptual_weight=train_cfg.perceptual_weight,
        norm_pix_loss=train_cfg.norm_pix_loss,
        perceptual_fn=perceptual_fn,
        loss_filters_dtype=train_cfg.loss_filters_dtype,
    )
    if pipe > 1:
        n_mb = train_cfg.pp_microbatches or pp.auto_microbatches(train_cfg.batch_size, pipe, data=size)
        step = pp.make_pp_train_step(model, mae_cfg.patch_size, mesh, n_microbatches=n_mb, **step_kw)
        print(f"Fold {fold_idx}: GPipe pipeline pipe={pipe} data={size} microbatches={n_mb}")
    else:
        step = make_train_step(model, mae_cfg.patch_size, **step_kw)
    augment_gen = torch.Generator(device=dev) if train_cfg.device_augment else None

    min_loss_path = os.path.join(ckpt_dir, MIN_LOSS_CHECKPOINT)
    jsonl = JsonlLogger(os.path.join(work_dir, "checkpoints")) if writer else Discard()
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
        # a pipelined run: one file per stage, written by its 'data' group's first rank
        resume_mgr = CheckpointManager(resume_dir, write=d == 0 if pipe > 1 else writer,
                                       stage=mesh.coords["pipe"] if pipe > 1 else None)
        state, restored_epoch, restored_min = resume_mgr.restore(state)
        if not pp.same_on_stages(-1 if restored_epoch is None else restored_epoch, mesh):
            raise ValueError(f"the stages' resume files in {resume_dir} hold different epochs (a run stopped "
                             "between their writes): start from the min-loss checkpoint in a fresh work dir")
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
        if train_cfg.device_data:
            batches = loader  # on the card already
        else:
            # with device_augment both views come from the raw batch on
            # the card: copying orig too would double the copies
            batches = cuda_prefetch(loader, size=2, device=dev, put_orig=not train_cfg.device_augment)
        for aug, orig, _ in logger.log_every(
            batches, header=f"Fold {fold_idx} Epoch [{epoch}]", length=len(loader)
        ):
            if augment_gen is not None:
                augment_gen.manual_seed(augment_seed(train_cfg.seed, fold_idx, epoch, count))
                aug, orig = device_augment_batch(
                    aug, augment_gen, data_cfg.use_z_score, per_channel=data_cfg.name == "egd",
                    rows=shard_rows)
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
        stats["volumes_per_sec"] = count * train_cfg.batch_size * size / epoch_time
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
        if stats["loss"] < min_loss:  # the group's mean loss: every rank keeps the same best
            min_loss = stats["loss"]
            best = {n: v.detach().clone() for n, v in model.state_dict().items()}  # this rank's blocks
            best_dirty = True
        jsonl.write({**{f"train_{n}": v for n, v in stats.items()}, "epoch": epoch,
                     "fold": fold_idx})
        if epoch % ck_every == ck_every - 1 or epoch == train_cfg.epochs - 1:
            # every rank gathers a sharded state; the writer writes
            if best_dirty:
                whole = pp.full_state_dict(model, best)
                if writer:
                    save_state_dict(min_loss_path, whole)
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
    else:
        best = pp.full_state_dict(model, best)
    print(f"Fold {fold_idx}: trained epochs [{start_epoch}, {train_cfg.epochs}) in "
          f"{time.time() - t_start:.0f}s, min loss {min_loss:.4f}")
    return mae_cfg, best, {"min_loss": min_loss}


def augment_seed(seed: int, fold_idx: int, epoch: int, count: int) -> int:
    """The seed of one step's augmentation draws: the JAX package folds
    epoch and step into PRNGKey(seed + 100 + fold); here they seed a
    `torch.Generator` through numpy's `SeedSequence`, so the draws depend on
    (seed, fold, epoch, step) alone and a resumed run repeats them."""
    return int(np.random.SeedSequence([seed + 100 + fold_idx, epoch, count]).generate_state(1, np.uint64)[0] >> 1)


def _check_layout(resume_dir: str, pipe: int, write: bool) -> None:
    """The JAX package's guard (pretrain_kfold.py:262-276 there): resume
    files carry the training layout, a pipelined run's one per stage, so a
    resume dir written with another `--pipe-devices` is refused; `write`
    records the layout of a fresh resume dir."""
    layout_file = os.path.join(resume_dir, "layout.json")
    if os.path.exists(layout_file):
        with open(layout_file) as f:
            have = json.load(f).get("pipe", 1)
        if have != pipe:
            raise ValueError(
                f"resume checkpoints in {resume_dir} were written with "
                f"--pipe-devices {have}; this run uses --pipe-devices "
                f"{pipe}. Resume with the same --pipe-devices, or start "
                f"from the layout-independent min-loss checkpoint in a "
                f"fresh work dir."
            )
    elif write:  # atomically: the other ranks may read it meanwhile
        os.makedirs(resume_dir, exist_ok=True)
        tmp = f"{layout_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"pipe": pipe}, f)
        os.replace(tmp, layout_file)


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
    (reference k_fold_…_brats.py:256-281 + utils/feature_extraction.py:9-45).
    Under a data mesh each rank runs its rows of each batch, and the first
    rank writes the gathered features; under a pipeline mesh the stages
    other than the first return at once."""
    dev = resolve_device(device)
    mesh = get_mesh()
    if mesh is not None and mesh.coords.get("pipe", 0) > 0:
        return
    vit_cfg = mae_cfg.encoder_vit_config(num_classes=num_classes, global_pool=True)
    model = build_grafted_vit(mae_sd, mae_cfg, vit_cfg, dev)
    d, size = data_coords(mesh)
    loader = Loader(dataset_no_aug, batch_size, indices=ids, shuffle=False, drop_last=False,
                    shard_rows=(d, size) if size > 1 else None)
    feats, labels = loader_features(model, loader, batch_size, dev)
    if d > 0:
        return
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{tag}_contrast_ssl_features_split_{fold_idx}.npy"), feats)
    np.save(os.path.join(out_dir, f"{tag}_contrast_ssl_labels_split_{fold_idx}.npy"), labels)


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
    CUDA is asked for and absent. `n_devices` > 1: one of that many ranks
    (module docstring)."""
    check_supported(train_cfg, n_devices)
    dev = resolve_device(device)
    transforms = default_ssl_transforms()
    if data_cfg.name == "egd":
        # EGD combined semantics (reference k_fold_…_egd.py:103-137): k-fold
        # over the LABELED pool; pretraining sees labeled-train + the whole
        # unlabeled SSL pool concatenated with offset ids; features come from
        # the labeled pool only
        split_dir = os.path.join(data_cfg.base_path, "splits")
        if train_cfg.device_augment:  # raw volumes, augmented on the card
            labeled_aug = EGDDataset(data_cfg.base_path, split_dir, mode="test", split=data_cfg.split, raw=True)
            ssl_aug = EGDDataset(data_cfg.base_path, split_dir, mode="ssl", split=data_cfg.split, raw=True)
        else:
            labeled_aug = get_dataset("egd", "test", data_cfg, transforms=transforms,
                                      use_z_score=data_cfg.use_z_score)
            ssl_aug = get_dataset("egd", "ssl", data_cfg, transforms=transforms,
                                  use_z_score=data_cfg.use_z_score)
        labeled_no_aug = get_dataset("egd", "test", data_cfg, transforms=None,
                                     use_z_score=data_cfg.use_z_score)
        dataset_aug = ConcatDataset([labeled_aug, ssl_aug])
        dataset_no_aug = labeled_no_aug
        labels = all_labels(labeled_no_aug)
        ssl_offset_ids = np.arange(len(ssl_aug)) + len(labeled_aug)
    else:
        if train_cfg.device_augment:  # raw volumes, augmented on the card
            dataset_aug = BraTSDataset(data_cfg.base_path, "whole", raw=True)
        else:
            dataset_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=transforms,
                                      use_z_score=data_cfg.use_z_score)
        dataset_no_aug = get_dataset(data_cfg.name, "whole", data_cfg, transforms=None,
                                     use_z_score=data_cfg.use_z_score)
        labels = all_labels(dataset_no_aug)
        ssl_offset_ids = None
    fold_list = folds if folds is not None else writer_first(lambda: kfold_indices(
        labels, n_splits, index_dir=os.path.join(work_dir, "k_fold", "indices_file")
    ))

    tb = TBWriter(os.path.join(work_dir, "logs")) if is_writer() else Discard()
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
