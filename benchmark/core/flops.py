"""The yardstick's arithmetic: analytic FLOPs of a training step, the
attention work and bytes of a step, and the chip's published peaks.

Every count is worked out from a configuration file's widths. The
conventions are those of the port's `utils/flops.py` (a copy, generalised
from `contr_mae_vit_base_patch16` at 96^3 / p8 to any configuration):

- a product's forward FLOPs are 2 M K N; its backward is twice that where
  both of its inputs need a gradient (a trained product counts 3x) and
  once where only one does: the patch embed (its input is data) and the
  prediction's Sobel passes (the band matrices are constants);
- attention's scores and P V count 4 N^2 D a block forward and twice that
  backward, with no recomputation: the shares measure useful work;
- elementwise work (LayerNorm, GELU, residuals, masking) is left out;
- the edge term's separable filters count as the banded products that
  compute them, S MACs a voxel and pass; the target's branch has no
  gradient.

`utils/flops.py` counts the patch embed's and the Sobel passes' backward
twice; here they count once, so a ViT-AE++ step of 32 is 29.14 TFLOP
against its 29.27. A share of a peak built on these counts cannot pass
100%: nothing here counts work that the step need not do.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # float32: the TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def tokens(cfg: dict) -> Dict[str, int]:
    """Patches, kept patches and the encoder's / decoder's sequence lengths
    (cls included) of a configuration."""
    grid = cfg["volume_size"] // cfg["patch_size"]
    n_patches = grid ** 3
    keep = int(n_patches * (1 - cfg["mask_ratio"]))
    return {"patches": n_patches, "keep": keep, "enc_n": keep + 1, "dec_n": n_patches + 1,
            "patch_dim": cfg["patch_size"] ** 3 * cfg["in_chans"]}


def block_flops(n_tokens: int, dim: int, mlp_ratio: float) -> float:
    """Forward product FLOPs of one pre-LN transformer block over n_tokens."""
    qkv = 2 * n_tokens * dim * 3 * dim
    attn = 4 * n_tokens * n_tokens * dim
    proj = 2 * n_tokens * dim * dim
    mlp = 2 * 2 * n_tokens * dim * int(mlp_ratio * dim)
    return float(qkv + attn + proj + mlp)


def encoder_rows(cfg: dict, batch: int) -> int:
    """Volumes through the encoder a step: both views when contrastive."""
    return 2 * batch if cfg["contrastive"] else batch


def mae_step_flops(cfg: dict, batch: int) -> Dict[str, float]:
    """FLOPs of one MAE training step of `batch` volumes: 'forward' and
    'total' (forward + backward) with the parts."""
    t = tokens(cfg)
    d, dd, r = cfg["embed_dim"], cfg["decoder_embed_dim"], cfg["mlp_ratio"]
    rows = encoder_rows(cfg, batch)
    embed = 2 * rows * t["patches"] * t["patch_dim"] * d
    encoder = cfg["depth"] * block_flops(t["enc_n"], d, r) * rows
    dec_embed = 2 * (batch * t["enc_n"]) * d * dd
    decoder = cfg["decoder_depth"] * block_flops(t["dec_n"], dd, r) * batch
    dec_pred = 2 * batch * t["dec_n"] * dd * t["patch_dim"]
    heads = 2 * (rows * t["enc_n"]) * (d * d) * 2 if cfg["contrastive"] else 0.0
    s = cfg["volume_size"]
    vox = batch * cfg["in_chans"] * s ** 3
    sobel_pred = 8 * 2 * vox * s
    target_branch = (3 + 8) * 2 * vox * s
    trained = encoder + dec_embed + decoder + dec_pred + heads
    fwd = trained + embed + sobel_pred + target_branch
    total = 3 * trained + 2 * (embed + sobel_pred) + target_branch
    return {"forward": fwd, "total": total, "encoder": encoder, "decoder": decoder, "embed": embed,
            "sobel_pred": sobel_pred}


def attention_calls(cfg: dict, batch: int):
    """[(B, H, N, d, layers)] of the attention calls of a training step of
    `batch` volumes: the encoder's and the decoder's."""
    t = tokens(cfg)
    d, dd = cfg["embed_dim"], cfg["decoder_embed_dim"]
    return [(encoder_rows(cfg, batch), cfg["num_heads"], t["enc_n"], d // cfg["num_heads"], cfg["depth"]),
            (batch, cfg["decoder_num_heads"], t["dec_n"], dd // cfg["decoder_num_heads"], cfg["decoder_depth"])]


def attention_least_seconds(calls, dtype: str, backward: bool) -> float:
    """The least time the chip could take over `calls`: per call the larger
    of its FLOPs at the dtype's peak and its bytes at HBM bandwidth.
    Forward 4 B H N^2 d, backward 8 B H N^2 d (no recomputation); bytes:
    q, k, v read and o written forward, q, k, v, o, dO read and dq, dk, dv
    written backward, each once."""
    elt = ELEMENT_BYTES[dtype]
    total = 0.0
    for b, h, n, d, layers in calls:
        fl = 4 * b * h * n * n * d
        by = 4 * b * n * h * d * elt
        total += layers * max(fl / PEAK_FLOPS[dtype], by / HBM_BYTES_PER_S)
        if backward:
            total += layers * max(2 * fl / PEAK_FLOPS[dtype], 2 * by / HBM_BYTES_PER_S)
    return total
