"""Named model presets.

The same constructors as the JAX package's models/zoo.py: each returns a
config; `build_model` turns a `ViTConfig` into the port's ViT. The MAE
itself is not ported yet, so an `MAEConfig` serves only for its encoder's
shape (`MAEConfig.encoder_vit_config`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from torch import nn

from vit_ae_plus_plus_torch.configs import MAEConfig, ViTConfig
from vit_ae_plus_plus_torch.models.vit import VisionTransformer3D


def mae_vit_base_patch16(**kw) -> MAEConfig:
    """ViT-B encoder, 512d/8L/16H decoder."""
    return MAEConfig(
        embed_dim=768, depth=12, num_heads=12,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16, **kw
    )


def mae_vit_large_patch16(**kw) -> MAEConfig:
    """ViT-L encoder."""
    return MAEConfig(
        embed_dim=1024, depth=24, num_heads=16,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=16, **kw
    )


def contr_mae_vit_base_patch16(**kw) -> MAEConfig:
    """Contrastive ViT-B MAE, the default pretraining architecture."""
    return mae_vit_base_patch16(contrastive=True, **kw)


def contr_mae_vit_base_patch16_fastdec(**kw) -> MAEConfig:
    """Opt-in, not the reference architecture: an 8-head (d=64) decoder in
    place of the 16-head (d=32) one; same widths and parameter shapes."""
    return MAEConfig(
        embed_dim=768, depth=12, num_heads=12,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=8,
        contrastive=True, **kw
    )


def contr_mae_vit_base_patch16_fast(**kw) -> MAEConfig:
    """Opt-in, not the reference architecture: 6-head (d=128) encoder and
    4-head (d=128) decoder at the same widths and parameter shapes."""
    return MAEConfig(
        embed_dim=768, depth=12, num_heads=6,
        decoder_embed_dim=512, decoder_depth=8, decoder_num_heads=4,
        contrastive=True, **kw
    )


def mae_vit_tiny_patch4(**kw) -> MAEConfig:
    """Tiny debug/test preset (not in the reference zoo)."""
    for k, v in dict(
        patch_size=4, embed_dim=24, depth=2, num_heads=3,
        decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2,
    ).items():
        kw.setdefault(k, v)
    return MAEConfig(**kw)


def contr_mae_vit_tiny_patch4(**kw) -> MAEConfig:
    return mae_vit_tiny_patch4(contrastive=True, **kw)


def contr_mae_vit_tiny_pp_patch4(**kw) -> MAEConfig:
    """Tiny preset with both stack depths divisible by 2."""
    kw.setdefault("decoder_depth", 2)
    return contr_mae_vit_tiny_patch4(**kw)


def vit_base_3d(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large_3d(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=1024, depth=24, num_heads=16, **kw)


MODEL_ZOO: Dict[str, Callable[..., Any]] = {
    "mae_vit_base_patch16": mae_vit_base_patch16,
    "mae_vit_large_patch16": mae_vit_large_patch16,
    "contr_mae_vit_base_patch16": contr_mae_vit_base_patch16,
    "contr_mae_vit_base_patch16_fastdec": contr_mae_vit_base_patch16_fastdec,
    "contr_mae_vit_base_patch16_fast": contr_mae_vit_base_patch16_fast,
    "mae_vit_tiny_patch4": mae_vit_tiny_patch4,
    "contr_mae_vit_tiny_patch4": contr_mae_vit_tiny_patch4,
    "contr_mae_vit_tiny_pp_patch4": contr_mae_vit_tiny_pp_patch4,
    "vit_base_3d": vit_base_3d,
    "vit_large_3d": vit_large_3d,
}


def build_model(cfg) -> nn.Module:
    """Config -> module. Only the ViT is ported so far."""
    if isinstance(cfg, ViTConfig):
        return VisionTransformer3D(cfg)
    if isinstance(cfg, MAEConfig):
        raise NotImplementedError(
            "the MAE is not ported yet; use cfg.encoder_vit_config() for its encoder"
        )
    raise TypeError(f"unknown config type {type(cfg)}")
