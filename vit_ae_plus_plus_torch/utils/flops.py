"""Analytic FLOP accounting for the flagship ViT-AE++ training step.

The port's copy of the JAX package's utils/flops.py: the MFU denominator of
a step of `contr_mae_vit_base_patch16` at 96^3 / patch 8, against the
reference's per-iteration arithmetic (reference
model/vit_autoenc.py:205-232). The reference computes the same trunk FLOPs but
adds a duplicate Sobel pass (its :222 builds both edge maps, then :224-225
recomputes each MSE branch), uses a dense 11^3 Gaussian conv (1331
MACs/voxel against 3x11 separable = 33), and runs attention by
materialising the (N, N) score tensor.

Conventions (stated, standard for MFU):
- matmul fwd FLOPs = 2*M*K*N; backward = 2x forward (dX and dW) for every
  parameter-bearing matmul -> total 3x forward;
- attention scores/PV counted at their algebraic cost 4*N^2*D per block
  (flash recomputation is NOT counted: MFU measures useful math);
- elementwise work (LayerNorm, GELU, residuals, masking) ignored: it is
  O(N*D) against O(N*D^2) matmuls;
- the gradient-free target branch (blur+Sobel on the target volume) counts
  forward-only; the prediction's Sobel branch counts forward + its
  transpose pass in backward (2x).
"""

from __future__ import annotations

from typing import Dict


def _block_flops(n_tokens: int, dim: int, mlp_ratio: float = 4.0) -> float:
    """Forward matmul FLOPs of one pre-LN transformer block for n_tokens."""
    qkv = 2 * n_tokens * dim * 3 * dim
    attn = 4 * n_tokens * n_tokens * dim  # QK^T + PV over all heads
    proj = 2 * n_tokens * dim * dim
    mlp = 2 * 2 * n_tokens * dim * int(mlp_ratio * dim)
    return float(qkv + attn + proj + mlp)


def flagship_step_flops(batch: int, volume: int = 96, patch: int = 8,
                        in_chans: int = 1) -> Dict[str, float]:
    """FLOPs per optimiser step of contr_mae_vit_base_patch16 at 96^3/p8,
    two contrastive views, mask ratio 0.75. Returns a breakdown dict with
    'total' (fwd+bwd) and 'forward'."""
    grid = volume // patch
    n_patches = grid ** 3                      # 1728
    keep = n_patches - int(n_patches * 0.75)   # 432
    enc_n = keep + 1                           # 433 (+cls)
    dec_n = n_patches + 1                      # 1729
    patch_dim = patch ** 3 * in_chans          # 512

    enc_tokens = 2 * batch * enc_n             # both contrastive views
    dec_tokens = batch * dec_n                 # decoder: view1 only

    embed = 2 * (2 * batch) * n_patches * patch_dim * 768      # patchify Dense
    encoder = 12 * (_block_flops(enc_n, 768)) * 2 * batch
    dec_embed = 2 * (batch * enc_n) * 768 * 512                # view1 latents only
    decoder = 8 * (_block_flops(dec_n, 512)) * batch
    dec_pred = 2 * dec_tokens * 512 * patch_dim
    heads = 2 * enc_tokens * (768 * 768) * 2                   # predictor: 2 Dense, both views

    # separable banded-matmul filters on (B, C, 96^3) f32 volumes: each 1-D
    # pass costs vox * S MACs. Sobel = 8 passes (ops/filters.py), blur = 3.
    vox = batch * in_chans * volume ** 3
    sobel_pred = 8 * 2 * vox * volume          # differentiable branch
    target_branch = (3 + 8) * 2 * vox * volume  # blur + sobel, no grad

    fwd = (embed + encoder + dec_embed + decoder + dec_pred + heads
           + sobel_pred + target_branch)
    # bwd: 2x fwd for everything with gradients; the target branch is
    # gradient-free (stop-gradient metric + constant target)
    bwd = 2 * (fwd - target_branch)
    return {
        "forward": fwd,
        "total": fwd + bwd,
        "encoder": encoder,
        "decoder": decoder,
        "filters": sobel_pred + target_branch,
        "embed_heads": embed + dec_embed + dec_pred + heads,
    }


# the dense bf16 tensor-core peak of one "NVIDIA H100 80GB HBM3, 700.00 W"
# (the SXM card): 989 TFLOP/s without sparsity, NVIDIA's H100 SXM data sheet
H100_SXM_BF16_PEAK_FLOPS = 989e12
