"""Model configuration for the PyTorch port.

A copy of the JAX package's `ViTConfig` and `MAEConfig`
(vit_ae_plus_plus_tpu/configs/config.py) holding only the fields the port
reads. Field names and defaults are the same, so a preset means the same
model in both packages.
"""

from __future__ import annotations

import dataclasses


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
    attn_impl: str = "auto"  # 'auto' | 'flash' | 'plain' (kernels/flash_attention.py)

    @property
    def grid_size(self) -> int:
        return self.volume_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**3


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """3D masked autoencoder; the port uses it for its encoder's shape."""

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
    contrastive: bool = False
    dtype: str = "float32"
    attn_impl: str = "auto"

    @property
    def grid_size(self) -> int:
        return self.volume_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size**3

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
        )
