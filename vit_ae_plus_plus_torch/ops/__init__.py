from vit_ae_plus_plus_torch.ops.augment import augment_draws, device_augment_batch
from vit_ae_plus_plus_torch.ops.filters import (
    gaussian_blur_3d,
    gaussian_blur_3d_conv,
    gaussian_blur_3d_dense,
    gaussian_kernel_1d,
    sobel_edges_3d,
    sobel_edges_3d_conv,
)
from vit_ae_plus_plus_torch.ops.losses import (
    at_least_f32,
    edge_map_loss,
    masked_mse_loss,
    negative_cosine_loss,
    soft_cross_entropy_with_weights,
    weighted_ce,
)
from vit_ae_plus_plus_torch.ops.masking import random_masking, restore_tokens
from vit_ae_plus_plus_torch.ops.patches import patch_grid_size, patchify, unpatchify
from vit_ae_plus_plus_torch.ops.pos_embed import get_3d_sincos_pos_embed, interpolate_pos_embed
from vit_ae_plus_plus_torch.ops.resize import resize_trilinear

__all__ = [
    "at_least_f32",
    "augment_draws",
    "device_augment_batch",
    "edge_map_loss",
    "gaussian_blur_3d",
    "gaussian_blur_3d_conv",
    "gaussian_blur_3d_dense",
    "gaussian_kernel_1d",
    "get_3d_sincos_pos_embed",
    "interpolate_pos_embed",
    "masked_mse_loss",
    "negative_cosine_loss",
    "patch_grid_size",
    "patchify",
    "random_masking",
    "resize_trilinear",
    "restore_tokens",
    "sobel_edges_3d",
    "sobel_edges_3d_conv",
    "soft_cross_entropy_with_weights",
    "unpatchify",
    "weighted_ce",
]
