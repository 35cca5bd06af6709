"""Model configuration for the PyTorch port.

A copy of the JAX package's `ViTConfig`, `MAEConfig`, `TrainConfig` and `DataConfig`
(vit_ae_plus_plus_tpu/configs/config.py) holding only the fields the port
reads. Field names and defaults are the same, so a preset means the same
model, and a config the same training run, in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LN_FUSION_MODES = ("auto", "on", "off")


def check_ln_fusion(mode: str) -> None:
    """`ln_fusion` takes 'auto', 'on' or 'off' (the JAX package's
    `_use_fused_ln`, models/vit.py there); anything else raises."""
    if mode not in LN_FUSION_MODES:
        raise ValueError(f"ln_fusion must be 'auto'|'on'|'off', got {mode!r}")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Encoder-only 3D ViT (classifier / feature extractor)."""

    volume_size: int = 96
    patch_size: int = 8
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_classes: int = 2
    global_pool: bool = True
    dtype: str = "float32"  # compute dtype; params stay float32
    attn_impl: str = "auto"  # 'auto' | 'flash' | 'plain' | 'flash_ring' | 'flash_seq' (kernels/flash_attention.py)
    ln_fusion: str = "auto"  # 'on': LayerNorm fused into qkv and fc1 (kernels/fused_ln_dense.py); 'auto' never fuses
    ln_dtype: str = "float32"  # "bfloat16": block-LN statistics in bf16 (models/vit.py ln_stats_dtype)

    def __post_init__(self):
        check_ln_fusion(self.ln_fusion)

    @property
    def grid_size(self) -> int:
        return self.volume_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**3


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """3D masked autoencoder (models/mae.py)."""

    volume_size: int = 96
    patch_size: int = 8
    in_chans: int = 1
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    decoder_embed_dim: int = 512
    decoder_depth: int = 8
    decoder_num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_pix_loss: bool = False
    contrastive: bool = False  # ContrastiveMAEViT variant (predictor head)
    use_proj: bool = False  # 3-layer projector: built but never applied in forward
    dtype: str = "float32"
    attn_impl: str = "auto"
    ln_fusion: str = "auto"  # as ViTConfig.ln_fusion, for the encoder and decoder blocks
    ln_dtype: str = "float32"  # as ViTConfig.ln_dtype

    def __post_init__(self):
        check_ln_fusion(self.ln_fusion)

    @property
    def grid_size(self) -> int:
        return self.volume_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**3

    @property
    def patch_dim(self) -> int:
        return self.patch_size**3 * self.in_chans

    def encoder_vit_config(self, num_classes: int = 2, global_pool: bool = True) -> ViTConfig:
        """The plain ViT that shares this MAE's encoder trunk."""
        return ViTConfig(
            volume_size=self.volume_size,
            patch_size=self.patch_size,
            in_chans=self.in_chans,
            embed_dim=self.embed_dim,
            depth=self.depth,
            num_heads=self.num_heads,
            mlp_ratio=self.mlp_ratio,
            num_classes=num_classes,
            global_pool=global_pool,
            dtype=self.dtype,
            attn_impl=self.attn_impl,
            ln_fusion=self.ln_fusion,
            ln_dtype=self.ln_dtype,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """SSL pretraining hyperparameters: every field of the JAX package's
    `TrainConfig`, with its defaults (the reference's config.ini [K_FOLD]
    and argparse defaults). `pretrain_kfold` refuses the fields whose
    paths are not ported yet (`device_augment`, `device_data`, `fsdp`,
    `pipe_devices > 1`, a data mesh); `donate_state` has no meaning in
    eager PyTorch and nothing reads it."""

    epochs: int = 50
    batch_size: int = 4
    accum_iter: int = 1
    blr: float = 1e-3  # absolute_lr = blr * eff_batch / 256
    lr: Optional[float] = None
    min_lr: float = 0.0
    warmup_epochs: float = 40.0
    weight_decay: float = 0.05
    mask_ratio: float = 0.75
    patch_size: int = 8
    clip_grad: Optional[float] = None
    seed: int = 42
    # loss weights
    use_edge_map: bool = True  # edge weight schedule 0.01 * (1 - epoch/epochs)
    perceptual_weight: float = 0.0
    vgg_ckpt: Optional[str] = None  # the perceptual term is not ported yet
    contr_weight: float = 0.001
    norm_pix_loss: bool = False
    # execution
    compute_dtype: str = "float32"  # "bfloat16" for throughput
    ln_dtype: str = "float32"
    loss_filters_dtype: str = "float32"  # "bfloat16": edge-loss filters in bf16
    device_augment: bool = False  # augment on the card (not ported yet)
    device_data: bool = False  # the whole raw fold resident on the card (not ported yet)
    donate_state: bool = True
    mesh_shape: Tuple[int, ...] = (1,)  # (data,) mesh; data > 1 is not ported yet
    pipe_devices: int = 1  # > 1: GPipe pipeline (not ported yet)
    pp_microbatches: Optional[int] = None
    fsdp: bool = False  # ZeRO/FSDP (not ported yet)
    start_epoch: int = 0
    resume: bool = False  # restore model, optimizer and epoch from the fold's resume checkpoint
    ckpt_every: int = 1  # write the resume checkpoint and flush the min-loss weights every N
    # epochs; in between, the best weights are held as a copy on the device
    nan_check_every: int = 50  # fetch the loss every k steps and stop on a non-finite one
    # (the only sync inside an epoch); 0 disables, the per-epoch check always runs
    profile_dir: Optional[str] = None  # torch.profiler trace of one steady epoch
    output_dir: str = "output_dir/k_fold"
    log_dir: str = "output_dir/k_fold"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset selection, mirroring config.ini [DATASET] (the JAX package's
    `DataConfig`, all fields)."""

    name: str = "brats"  # 'brats' | 'egd'
    mode: str = "whole"
    split: str = "idh"  # egd only: 'idh' | '1p19q'
    use_z_score: bool = True
    in_channels: int = 1
    volume_size: int = 96
    num_classes: int = 2
    base_path: str = ""  # root of the prepared split arrays
