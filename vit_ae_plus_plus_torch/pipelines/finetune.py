"""Supervised downstream training: full fine-tune and linear probe.

The port's counterpart of the JAX package's pipelines/finetune.py, with its
parity targets:
- fine-tune: reference post_training_utils/fine_tune_epoch.py:34-469 —
  class-weighted CE (hard, or soft + mixup), AdamW with BEiT layer-wise LR
  decay, per-iteration warmup-cosine, `evaluate` collecting all logits then
  roc_auc / specificity / sensitivity, best models by three criteria, final
  test evaluation of each;
- linear probe: reference k_fold_training_scripts/
  k_fold_cross_valid_linear_projection.py:31-388 — the same loop with the
  backbone frozen (exactly 2 trainable tensors asserted), SGD(momentum 0.9)
  and the reference's own MixUp3D;
- head init trunc_normal(std=2e-5) after loading the pretrained trunk
  (fine_tune_epoch.py:334, linear_projection.py:233).

The frozen backbone is `requires_grad` off on every parameter but the head
(train/optim.py `freeze_backbone_tx`): the trunk's forward builds no
autograd graph, so a probe step runs the attention forward kernels and
never their backward. The step's loss stays on the card; a training epoch
fetches its losses once, at its end.

Random streams differ from the JAX package's: the head is drawn from a
`torch.Generator`, and mixup's Beta lambdas and permutation from a numpy
`Generator` seeded with (rng, step), the counterpart of JAX's
`fold_in(rng, step)` (torch has no Beta sampler that takes a generator).
The mixup functions themselves take their draws as arguments.

Data parallelism (`n_devices` > 1, each of that many ranks under a mesh of
(n_devices, 1), as the CLI's `--n-devices` launches them; the JAX package's
`make_supervised_steps(..., mesh=...)`): `batch_size` is the global batch,
and each rank loads and steps on its rows of the one-process batches
(`Loader(shard_rows=...)`). The step takes this rank's share of the
global batch's loss (the soft cross entropy sums over the rows,
`weighted_ce` divides by the global batch's sum of weights) times D, and
averages the gradients and the loss over the 'data' group. Mixup pairs
rows across the global batch (timm's flip, MixUp3D's permutation), so the
step gathers the global batch, mixes it with the draws every rank shares
and keeps its own rows. `evaluate` gathers the logits in the one-process
order, so every rank computes the same statistics and the trackers decide
alike; the group's first rank alone writes the best models, logs and
resume files, and the others read them after a barrier.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import Loader, default_ssl_transforms, get_dataset
from vit_ae_plus_plus_torch.data.loader import cuda_prefetch
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models import MODEL_ZOO
from vit_ae_plus_plus_torch.ops import soft_cross_entropy_with_weights, weighted_ce
from vit_ae_plus_plus_torch.parallel import (
    all_gather_batch,
    all_reduce_sum,
    barrier,
    data_coords,
    data_parallel,
    get_mesh,
)
from vit_ae_plus_plus_torch.pipelines.extract_features import global_rows
from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import requested_devices
from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
from vit_ae_plus_plus_torch.train import create_train_state, warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, save_state_dict
from vit_ae_plus_plus_torch.train.metrics import Discard, JsonlLogger, MetricLogger, TBWriter
from vit_ae_plus_plus_torch.train.optim import freeze_backbone_tx, make_layerwise_adamw, make_sgd
from vit_ae_plus_plus_torch.train.step import average_grads, data_mean
from vit_ae_plus_plus_torch.utils.locking import locked_workdir
from vit_ae_plus_plus_torch.utils.metrics import roc_auc


def check_supported(train_cfg: TrainConfig, n_devices: Optional[int] = None,
                    command: str = "finetune") -> Tuple[int, int]:
    """Raise `ValueError` when the ambient mesh is not the data mesh of
    `n_devices` (`parallel.data_parallel`). -> (d, D) on the 'data' axis.
    `accum_iter` only scales the learning rate here, as in the JAX package
    (finetune.py:302, probe_kfold.py:108 there): no optimizer of these
    commands accumulates."""
    return data_parallel(requested_devices(train_cfg, n_devices), command)


def mixup_3d_draws(rng: np.random.Generator, n: int, alpha: float = 0.1) -> Tuple[np.ndarray, float, float]:
    """MixUp3D's draws, in the JAX package's order: the permutation, then the
    inputs' and the targets' Beta(alpha, alpha) lambdas."""
    perm = rng.permutation(n)
    return perm, float(rng.beta(alpha, alpha)), float(rng.beta(alpha, alpha))


def mixup_3d(inputs: torch.Tensor, one_hot_targets: torch.Tensor, perm, lam_x: float, lam_y: float):
    """MixUp3D (linear_projection.py:31-45): the permuted convex combination
    of the inputs with `lam_x` and of the one-hot targets with `lam_y` (the
    reference samples one lambda per `partial_mixup` call)."""
    idx = torch.as_tensor(np.array(perm), device=inputs.device)
    lx = torch.tensor(lam_x, dtype=inputs.dtype)
    ly = torch.tensor(lam_y, dtype=one_hot_targets.dtype)
    mixed_x = inputs * lx + inputs[idx] * (1 - lx)
    mixed_y = one_hot_targets * ly + one_hot_targets[idx] * (1 - ly)
    return mixed_x, mixed_y


def timm_mixup(inputs: torch.Tensor, int_labels: torch.Tensor, num_classes: int, lam: float,
               smoothing: float = 0.1):
    """timm 0.5.4 `Mixup(mixup_alpha=0.1, num_classes=2)` as the reference
    fine-tune uses it (fine_tune_epoch.py:366-368): one lambda for inputs and
    targets, the flipped batch as the partner, label smoothing 0.1 inside
    the target transform. -> (mixed inputs, soft targets in f32)."""
    lam_x = torch.tensor(lam, dtype=torch.float32).to(inputs.dtype)
    mixed_x = inputs * lam_x + inputs.flip(0) * (1 - lam_x)
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    y1 = torch.nn.functional.one_hot(int_labels, num_classes).float() * (on - off) + off
    lam32 = lam_x.float()
    return mixed_x, y1 * lam32 + y1.flip(0) * (1 - lam32)


def head_init_2e5(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Re-initialise the head: weight 2e-5 * a normal truncated to [-2, 2],
    drawn on the host from `generator`, bias zero (fine_tune_epoch.py:334)."""
    head = model.head
    w = torch.empty(head.weight.shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        head.weight.copy_(2e-5 * w)
        head.bias.zero_()


def make_supervised_steps(
    model: torch.nn.Module,
    *,
    num_classes: int,
    class_weights: Optional[np.ndarray] = None,
    use_mixup: bool = False,
    mixup_alpha: float = 0.1,
    mixup_impl: str = "timm",
) -> Tuple[Callable, Callable]:
    """(train_step, eval_step) for a classifier ViT.

    `train_step(state, batch, labels, rng) -> (state, {"loss"})`: one update
    of `state.tx`'s parameters; `rng` (an int) seeds the step's mixup draws
    with the state's step. mixup_impl 'timm' is the fine-tune reference's
    timm Mixup, 'reference' the probe reference's MixUp3D.
    `eval_step(batch, labels) -> (logits, loss)` without gradients, the
    unmixed weighted CE. Both take tensors on the model's device; the loss
    stays there. Under a data mesh each rank passes its rows of the global
    batch (module docstring), and both losses are the global batch's."""
    device = next(model.parameters()).device
    cw = torch.as_tensor(
        class_weights if class_weights is not None else np.ones(num_classes), dtype=torch.float32,
        device=device,
    )

    def weight_sum(labels, mesh, size):
        """`weighted_ce`'s denominator for this rank's rows: the global
        batch's sum of weights (None: the rows' own, without a data mesh)."""
        return all_reduce_sum(cw[labels].sum(), mesh, "data") if size > 1 else None

    def train_step(state, batch: torch.Tensor, labels, rng: int):
        labels = torch.as_tensor(labels, dtype=torch.int64, device=batch.device)
        m = state.model
        m.train()
        mesh = get_mesh()
        d, size = data_coords(mesh)
        if use_mixup:
            # the partners come from the whole global batch, so mix it and
            # keep this rank's rows
            b = batch.shape[0]
            batch_g, labels_g = (all_gather_batch(t, mesh) if size > 1 else t for t in (batch, labels))
            draws = np.random.default_rng([rng, state.step])
            if mixup_impl == "timm":
                x, y = timm_mixup(batch_g, labels_g, num_classes, float(draws.beta(mixup_alpha, mixup_alpha)))
            else:
                one_hot = torch.nn.functional.one_hot(labels_g, num_classes).float()
                x, y = mixup_3d(batch_g, one_hot, *mixup_3d_draws(draws, batch_g.shape[0], mixup_alpha))
            loss = soft_cross_entropy_with_weights(m(x[d * b:(d + 1) * b]), y[d * b:(d + 1) * b], cw)
        else:
            loss = weighted_ce(m(batch), labels, cw, weight_sum(labels, mesh, size))
        # this rank's share of the global batch's loss, times D: the group's
        # means of it and of its gradients (`average_grads`) are the global
        # batch's
        loss = loss * size
        for p in state.tx.params:
            p.grad = None
        loss.backward()
        for p in state.tx.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        average_grads(state.tx.params)
        state.tx.step()
        state.step += 1
        return state, data_mean({"loss": loss.detach()})

    def eval_step(batch: torch.Tensor, labels):
        labels = torch.as_tensor(labels, dtype=torch.int64, device=batch.device)
        model.eval()
        mesh = get_mesh()
        size = data_coords(mesh)[1]
        with torch.inference_mode():
            logits = model(batch)
            loss = weighted_ce(logits, labels, cw, weight_sum(labels, mesh, size))
            return logits, all_reduce_sum(loss, mesh, "data") if size > 1 else loss

    return train_step, eval_step


def train_one_epoch(train_step, state, loader: Loader, rng: int, schedule, epoch: int, tb: TBWriter,
                    header: str, device: torch.device):
    """One epoch of `train_step` over `loader` (batches copied to the card
    ahead of the step). The losses are fetched once, at the end; each
    step's loss and learning rate then go to `tb` at the epoch_1000x x-axis,
    as the JAX package writes them step by step. -> (state, losses)."""
    n_iter = max(len(loader), 1)
    logger = MetricLogger()
    losses = []
    batches = cuda_prefetch(loader, size=2, device=device, put_orig=False)
    for aug, _orig, lab in logger.log_every(batches, header=header, length=len(loader)):
        state, metrics = train_step(state, aug, lab, rng)
        losses.append(metrics["loss"])
    values = torch.stack(losses).tolist() if losses else []
    for it, v in enumerate(values):
        tb.scalars({"loss": v, "lr": float(schedule(epoch * n_iter + it))}, epoch + it / n_iter)
    if values:
        logger.update(loss=float(np.mean(values)))
        print(f"{header} mean {logger}")
    return state, values


def evaluate(eval_step, loader: Loader, pad_batch: int, device=None) -> Dict[str, float]:
    """Collect logits over a loader and compute roc_auc / specificity /
    sensitivity / loss (fine_tune_epoch.py:104-145). A partial batch is
    padded to `pad_batch` with its first volume and label; the loss is the
    mean of the batches' losses, as the JAX package takes it. Logits and
    losses are fetched from the card once. A row-sharded loader
    (`shard_rows`) pads its own rows; the logits and labels are gathered in
    the one-process order, and the eval step's losses are the global
    batch's, so every rank returns the same dict."""
    dev = resolve_device(device)
    all_logits, all_labels, losses = [], [], []
    for aug, _orig, labels in cuda_prefetch(loader, size=2, device=dev, put_orig=False):
        n = aug.shape[0]
        lab = torch.as_tensor(labels, dtype=torch.int64, device=dev)
        if n < pad_batch and loader.shard_rows is None:
            aug = torch.cat([aug, aug[:1].expand(pad_batch - n, *aug.shape[1:])])
            lab = torch.cat([lab, lab[:1].expand(pad_batch - n)])
        logits, loss = eval_step(aug, lab)
        all_logits.append(logits[:n])
        all_labels.append(lab[:n])
        losses.append(loss)
    logits = global_rows(loader, torch.cat(all_logits)).float().cpu().numpy()
    labels = global_rows(loader, torch.cat(all_labels)).cpu().numpy()
    auc, spec, sens = roc_auc(logits, labels)
    return {
        "roc_auc_score": auc,
        "specificity": spec,
        "sensitivity": sens,
        "loss": float(np.mean(torch.stack(losses).tolist())),
    }


@dataclasses.dataclass
class BestModelTracker:
    """3-criteria best-model selection (fine_tune_epoch.py:436-463): each
    criterion that improves on validation writes the model's weights as a
    reference-layout `checkpoint-{name}[_{fold}].pth` in `out_dir` (where
    `write`: on a data group's first rank only)."""

    out_dir: str
    write: bool = True
    criteria: Tuple[str, ...] = ("roc_auc_score", "specificity", "sensitivity")
    names: Tuple[str, ...] = ("best_ft_model", "best_spec_model", "best_sens_model")

    def __post_init__(self):
        self.best = {c: 0.0 for c in self.criteria}
        if self.write:
            os.makedirs(self.out_dir, exist_ok=True)

    def path(self, name: str, fold: Optional[int] = None) -> str:
        tag = f"{name}_{fold}" if fold is not None else name
        return os.path.join(self.out_dir, f"checkpoint-{tag}.pth")

    def update(self, val_stats: Dict[str, float], model: torch.nn.Module, fold: Optional[int] = None):
        host = None
        for crit, name in zip(self.criteria, self.names):
            if val_stats[crit] > self.best[crit]:
                self.best[crit] = val_stats[crit]
                if not self.write:
                    continue
                if host is None:  # one copy to the host for all the criteria
                    host = {k: v.detach().cpu() for k, v in model.state_dict().items()}
                save_state_dict(self.path(name, fold), host)


def build_classifier(data_cfg: DataConfig, train_cfg: TrainConfig, model_name: str, checkpoint_path: str,
                     device: torch.device, patch_size: Optional[int] = None):
    """The classifier ViT with the MAE checkpoint's encoder grafted in and
    the head drawn by `head_init_2e5` from seed + 7, on `device`. ->
    (vit_cfg, model). `patch_size` None keeps the preset's."""
    kw = {} if patch_size is None else {"patch_size": patch_size}
    mae_cfg = MODEL_ZOO[model_name](
        volume_size=data_cfg.volume_size, in_chans=data_cfg.in_channels,
        dtype=train_cfg.compute_dtype, **kw,
    )
    vit_cfg = mae_cfg.encoder_vit_config(num_classes=data_cfg.num_classes, global_pool=True)
    model = build_grafted_vit(load_reference_state_dict(checkpoint_path), mae_cfg, vit_cfg, device)
    head_init_2e5(model, torch.Generator().manual_seed(train_cfg.seed + 7))
    return vit_cfg, model


def make_tx(vit_cfg, train_cfg: TrainConfig, schedule, fix_backbone: bool, layer_decay: float):
    """Frozen-backbone SGD(0.9) or layer-wise AdamW, as a recipe."""
    if fix_backbone:
        return freeze_backbone_tx(make_sgd(schedule, momentum=0.9))
    return make_layerwise_adamw(vit_cfg.depth, schedule, weight_decay=train_cfg.weight_decay,
                                layer_decay=layer_decay)


def log_epoch(tb_train: TBWriter, tb_val: TBWriter, train_stats: Dict, val_stats: Dict, epoch: int) -> None:
    """The per-epoch ft/* scalars of both channels (fine_tune_epoch.py:416-419)."""
    tb_val.scalars_at({"ft/roc_auc_score": val_stats["roc_auc_score"], "ft/loss": val_stats["loss"]}, epoch)
    tb_train.scalars_at({"ft/roc_auc_score": train_stats["roc_auc_score"], "ft/loss": train_stats["loss"]},
                        epoch)


@locked_workdir  # refuse a second live writer (utils/locking.py)
def finetune_single(
    data_cfg: DataConfig,
    train_cfg: TrainConfig,
    work_dir: str,
    checkpoint_path: str,
    model_name: str = "contr_mae_vit_base_patch16",
    fix_backbone: bool = False,
    use_mixup: bool = False,
    class_weights=None,
    layer_decay: float = 0.75,
    blr: float = 1e-3,
    eval_only: bool = False,
    n_devices: Optional[int] = None,
    device=None,
) -> Dict:
    """Single-run fine-tune over the train/val/test splits (reference
    post_training_utils/fine_tune_epoch.py:216-443): graft the MAE
    checkpoint (a reference-layout `.pth`) into a classifier ViT, head init
    trunc_normal(2e-5), layer-wise AdamW (or frozen-backbone SGD), per-epoch
    train and train/val evaluation, best models by three criteria, final
    test evaluation of each -> {name: test stats}. Runs on `cuda` unless
    `device` names another device, and raises when CUDA is asked for and
    absent. `n_devices` > 1: one of that many ranks (module docstring)."""
    d, size = check_supported(train_cfg, n_devices, "finetune")
    shard = (d, size) if size > 1 else None
    dev = resolve_device(device)
    ds_train = get_dataset(data_cfg.name, "train", data_cfg, transforms=default_ssl_transforms(),
                           use_z_score=data_cfg.use_z_score)
    ds_val = get_dataset(data_cfg.name, "val", data_cfg, transforms=None, use_z_score=data_cfg.use_z_score)
    ds_test = get_dataset(data_cfg.name, "test", data_cfg, transforms=None, use_z_score=data_cfg.use_z_score)

    vit_cfg, model = build_classifier(data_cfg, train_cfg, model_name, checkpoint_path, dev,
                                      patch_size=train_cfg.patch_size)
    loader = Loader(ds_train, train_cfg.batch_size, shuffle=True, drop_last=True, seed=train_cfg.seed,
                    shard_rows=shard)
    # effective batch incl. grad accumulation (fine_tune_epoch.py:343-346)
    eff_batch = train_cfg.batch_size * train_cfg.accum_iter
    lr = train_cfg.lr if train_cfg.lr is not None else blr * eff_batch / 256
    sched = warmup_cosine_schedule(lr, train_cfg.min_lr, train_cfg.warmup_epochs, train_cfg.epochs,
                                   max(len(loader), 1))
    state = create_train_state(model, make_tx(vit_cfg, train_cfg, sched, fix_backbone, layer_decay))
    train_step, eval_step = make_supervised_steps(
        model, num_classes=data_cfg.num_classes, class_weights=class_weights, use_mixup=use_mixup,
    )

    writer = d == 0
    tracker = BestModelTracker(os.path.join(work_dir, "checkpoints"), write=writer)
    jsonl = JsonlLogger(work_dir) if writer else Discard()
    # the reference's two TensorBoard channels (fine_tune_epoch.py:271-272)
    tb_train = TBWriter(os.path.join(work_dir, "logs", "train_ft")) if writer else Discard()
    tb_val = TBWriter(os.path.join(work_dir, "logs", "val_ft")) if writer else Discard()
    rng = train_cfg.seed
    val_loader = Loader(ds_val, train_cfg.batch_size, shuffle=False, drop_last=False, shard_rows=shard)
    # trainable-parameter count, requires_grad semantics (fine_tune_epoch.py:340)
    n_parameters = int(sum(p.numel() for p in model.parameters() if p.requires_grad))
    try:
        for epoch in range(0 if eval_only else train_cfg.epochs):
            state, _ = train_one_epoch(train_step, state, loader, rng, sched, epoch, tb_train,
                                       f"FT Epoch [{epoch}]", dev)
            train_stats = evaluate(eval_step, Loader(ds_train, train_cfg.batch_size, shuffle=False,
                                                     drop_last=False, shard_rows=shard),
                                   train_cfg.batch_size, dev)
            val_stats = evaluate(eval_step, val_loader, train_cfg.batch_size, dev)
            tracker.update(val_stats, model)
            log_epoch(tb_train, tb_val, train_stats, val_stats, epoch)
            jsonl.write({**{f"train_val_{k}": v for k, v in train_stats.items()},
                         **{f"val_{k}": v for k, v in val_stats.items()}, "epoch": epoch,
                         # reference log_stats carries the trainable-param count
                         # (fine_tune_epoch.py:424)
                         "n_parameters": n_parameters})
    finally:
        tb_train.close()
        tb_val.close()

    # final test evaluation of the three best checkpoints (fine_tune_epoch.py:436-443),
    # which the group's first rank has written
    barrier(get_mesh())
    test_loader = Loader(ds_test, train_cfg.batch_size, shuffle=False, drop_last=False, shard_rows=shard)
    results = {}
    for name in tracker.names:
        path = tracker.path(name)
        if os.path.exists(path):
            model.load_state_dict(load_reference_state_dict(path), strict=True)
            results[name] = evaluate(eval_step, test_loader, train_cfg.batch_size, dev)
    return results
