"""Attention for the port: plain PyTorch versions beside the wrappers of the
hand-written CUDA kernel in csrc/flash_fwd.cu (built at first use)."""

from vit_ae_plus_plus_torch.kernels.flash_attention import (
    attention_plain,
    flash_attention,
    kernel_tolerance,
    multihead_attention,
)
from vit_ae_plus_plus_torch.kernels.packed_flash import (
    packed_attention_plain,
    packed_flash_attention,
)

__all__ = [
    "attention_plain",
    "flash_attention",
    "kernel_tolerance",
    "multihead_attention",
    "packed_attention_plain",
    "packed_flash_attention",
]
