"""Stand-alone SSL feature extraction from a chosen checkpoint.

The port's counterpart of the JAX package's pipelines/extract_features.py
(reference post_training_utils/extract_ssl_features.py:20-154): load a
pretrained MAE checkpoint, graft its encoder into a plain ViT
(pipelines/transfer.py), and dump `{split}_features.npy` (f32) and
`{split}_gt_labels.npy` for the requested split(s). The checkpoint is a
reference-layout `.pth`, as `pretrain-kfold` writes it
(`checkpoints/fold_k/checkpoint-min_loss.pth`) or the JAX package's
`export-torch`; the JAX package reads its orbax directories instead.

`quantize="int8"` runs the int8 engine (models/quant.py) over the grafted
weights, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from vit_ae_plus_plus_torch.configs import DataConfig
from vit_ae_plus_plus_torch.data import Loader, get_dataset
from vit_ae_plus_plus_torch.data.loader import cuda_prefetch
from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models import MODEL_ZOO
from vit_ae_plus_plus_torch.models.quant import QuantizedViT
from vit_ae_plus_plus_torch.parallel import all_gather_batch, data_parallel, get_mesh
from vit_ae_plus_plus_torch.pipelines.transfer import build_grafted_vit
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict
from vit_ae_plus_plus_torch.train.step import feature_step


def global_rows(loader: Loader, t: torch.Tensor) -> torch.Tensor:
    """`t`, this rank's rows of each of `loader`'s batches one after the
    other, as the one-process run's rows of all of them: under
    `shard_rows`, gathered over the ambient mesh's 'data' group into the
    global order with the last batch's pad rows cut; else `t` itself."""
    if loader.shard_rows is None:
        return t
    size = loader.shard_rows[1]
    rows = all_gather_batch(t, get_mesh())  # (D * batches * b, ...): rank after rank
    rows = rows.view(size, len(loader), -1, *t.shape[1:]).transpose(0, 1).reshape(-1, *t.shape[1:])
    return rows[:len(loader.indices)]


def loader_features(model, loader: Loader, batch_size: int, device: torch.device
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """`feature_step` over every batch of `loader` -> (f32 features, labels)
    as numpy. The last partial batch is padded with its first volume to
    `batch_size`, so every call runs at one shape; the features are fetched
    from the card once, at the end. A row-sharded loader (`shard_rows`)
    gives this rank's rows of each batch, already padded, and the result is
    the whole run's on every rank (`global_rows`)."""
    model.eval()
    feats, labels = [], []
    for aug, _orig, lab in cuda_prefetch(loader, size=2, device=device, put_orig=False):
        n = aug.shape[0]
        if n < batch_size and loader.shard_rows is None:
            aug = torch.cat([aug, aug[:1].expand(batch_size - n, *aug.shape[1:])])
        feats.append(feature_step(model, aug)[:n])
        labels.append(torch.from_numpy(lab))
    feats = global_rows(loader, torch.cat(feats))
    labels = global_rows(loader, torch.cat(labels).to(feats.device)).cpu().numpy()
    # float32 on disk whatever the compute dtype: numpy has no bfloat16, and
    # the downstream readers are numpy and scikit-learn
    return feats.float().cpu().numpy(), labels


def extract_ssl_features(
    data_cfg: DataConfig,
    checkpoint_path: str,
    out_dir: str,
    model_name: str = "contr_mae_vit_base_patch16",
    batch_size: int = 16,
    only_test_split: bool = False,
    patch_size: int = 8,
    compute_dtype: str = "float32",
    quantize: str = "none",
    n_devices: Optional[int] = None,
    device=None,
) -> None:
    """Runs on `cuda` unless `device` names another device, and raises when
    CUDA is asked for and absent. `n_devices` > 1: one of that many ranks,
    each under a data mesh of (n_devices, 1) (the CLI's `--n-devices`
    launches them): each rank runs its rows of each batch of `batch_size`,
    and the first writes the features in the one-process order."""
    if quantize not in ("none", "int8"):
        raise ValueError(f"quantize must be 'none'|'int8', got {quantize!r}")
    d, size = data_parallel(n_devices, "extract-features")
    if data_cfg.name == "egd" and not only_test_split:
        raise ValueError(
            "EGD has no 'train' feature split — the labelled pool is mode='test' "
            "(reference egd.py:19-39); pass only_test_split=True / --only-test-split"
        )
    dev = resolve_device(device)
    mae_cfg = MODEL_ZOO[model_name](
        volume_size=data_cfg.volume_size, in_chans=data_cfg.in_channels,
        patch_size=patch_size, dtype=compute_dtype,
    )
    vit_cfg = mae_cfg.encoder_vit_config(num_classes=data_cfg.num_classes, global_pool=True)
    model = build_grafted_vit(load_reference_state_dict(checkpoint_path), mae_cfg, vit_cfg, dev)
    if quantize == "int8":
        model = QuantizedViT(model.state_dict(), vit_cfg)

    splits = ["test"] if only_test_split else ["train", "test"]
    for split in splits:
        dataset = get_dataset(data_cfg.name, split if data_cfg.name == "brats" else "test",
                              data_cfg, transforms=None, use_z_score=data_cfg.use_z_score)
        loader = Loader(dataset, batch_size, shuffle=False, drop_last=False,
                        shard_rows=(d, size) if size > 1 else None)
        feats, labels = loader_features(model, loader, batch_size, dev)
        if d > 0:  # the first rank of the data group writes
            continue
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{split}_features.npy"), feats)
        np.save(os.path.join(out_dir, f"{split}_gt_labels.npy"), labels)
        print(f"Saved {split} features: {feats.shape[0]} items")
