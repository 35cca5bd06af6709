from vit_ae_plus_plus_torch.ops.filters import gaussian_blur_3d, gaussian_kernel_1d, sobel_edges_3d
from vit_ae_plus_plus_torch.ops.losses import (
    at_least_f32,
    edge_map_loss,
    masked_mse_loss,
    negative_cosine_loss,
)
from vit_ae_plus_plus_torch.ops.masking import random_masking, restore_tokens
from vit_ae_plus_plus_torch.ops.patches import patch_grid_size, patchify, unpatchify
from vit_ae_plus_plus_torch.ops.pos_embed import get_3d_sincos_pos_embed

__all__ = [
    "at_least_f32",
    "edge_map_loss",
    "gaussian_blur_3d",
    "gaussian_kernel_1d",
    "get_3d_sincos_pos_embed",
    "masked_mse_loss",
    "negative_cosine_loss",
    "patch_grid_size",
    "patchify",
    "random_masking",
    "restore_tokens",
    "sobel_edges_3d",
    "unpatchify",
]
