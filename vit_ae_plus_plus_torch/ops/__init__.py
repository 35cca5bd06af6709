from vit_ae_plus_plus_torch.ops.patches import patch_grid_size, patchify, unpatchify
from vit_ae_plus_plus_torch.ops.pos_embed import get_3d_sincos_pos_embed

__all__ = ["get_3d_sincos_pos_embed", "patch_grid_size", "patchify", "unpatchify"]
