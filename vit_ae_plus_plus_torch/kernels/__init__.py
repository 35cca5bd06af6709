"""The port's kernels: plain PyTorch versions beside the wrappers of the
hand-written CUDA kernels (built at first use) for attention
(csrc/flash_fwd.cu, csrc/flash_bwd.cu; with a key bias, the ring's partial
steps), LayerNorm (csrc/layernorm.cu) and LayerNorm fused into the next
Dense layer (csrc/ln_dense.cu), and the sequence-parallel attention over a
`parallel` mesh (ring_flash.py, seq_flash.py). Each wrapper counts its
kernel's launches, in total (`launches`) and by shape and dtype
(`launches_by_shape`)."""

from vit_ae_plus_plus_torch.kernels.flash_attention import (
    attention_bwd_plain,
    attention_plain,
    bwd_tolerance,
    flash_attention,
    flash_attention_bwd,
    kernel_tolerance,
    multihead_attention,
)
from vit_ae_plus_plus_torch.kernels.fused_ln import (
    fused_layernorm,
    layernorm_bwd,
    layernorm_bwd_plain,
    layernorm_plain,
)
from vit_ae_plus_plus_torch.kernels.fused_ln_dense import (
    fused_ln_dense,
    ln_dense_bwd,
    ln_dense_bwd_plain,
    ln_dense_plain,
)
from vit_ae_plus_plus_torch.kernels.packed_flash import (
    packed_attention_bwd_plain,
    packed_attention_plain,
    packed_flash_attention,
    packed_flash_attention_bwd,
)
from vit_ae_plus_plus_torch.kernels.ring_flash import (
    merge,
    ring_flash_attention,
    ring_partial_bwd,
    ring_partial_fwd,
)
from vit_ae_plus_plus_torch.kernels.seq_flash import seq_sharded_flash_attention


def reset_launch_counts() -> None:
    """Set every wrapper's launch counts to 0."""
    for wrapper in (flash_attention, flash_attention_bwd, packed_flash_attention, packed_flash_attention_bwd,
                    fused_layernorm, layernorm_bwd, fused_ln_dense, ln_dense_bwd, ring_partial_fwd,
                    ring_partial_bwd):
        wrapper.launches = 0
        wrapper.launches_by_shape = {}


__all__ = [
    "attention_bwd_plain",
    "attention_plain",
    "bwd_tolerance",
    "flash_attention",
    "flash_attention_bwd",
    "fused_layernorm",
    "fused_ln_dense",
    "kernel_tolerance",
    "layernorm_bwd",
    "layernorm_bwd_plain",
    "layernorm_plain",
    "ln_dense_bwd",
    "ln_dense_bwd_plain",
    "ln_dense_plain",
    "merge",
    "multihead_attention",
    "packed_attention_bwd_plain",
    "packed_attention_plain",
    "packed_flash_attention",
    "packed_flash_attention_bwd",
    "reset_launch_counts",
    "ring_flash_attention",
    "ring_partial_bwd",
    "ring_partial_fwd",
    "seq_sharded_flash_attention",
]
