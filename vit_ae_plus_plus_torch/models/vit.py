"""3D Vision Transformer trunk in PyTorch.

Counterpart of the JAX package's models/vit.py: pre-LN blocks
`x + attn(LN(x))`, `x + mlp(LN(x))`, LayerNorm eps 1e-6, qkv bias, exact-erf
GELU MLP. Parameter names are the reference PyTorch keys
(`patch_embed.proj.weight` as a Conv3d weight (D, C, p, p, p),
`blocks.N.attn.qkv.weight`, `blocks.N.mlp.fc1.weight`, `fc_norm.weight`, ...).

Precision follows the JAX package: parameters stay f32; every product runs
in the compute dtype (weights are cast per call); LayerNorm statistics are
f32 and the result is cast back; attention's softmax is f32 (kernels/).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.kernels import multihead_attention, packed_flash_attention
from vit_ae_plus_plus_torch.ops import patchify

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Dense in x's dtype over f32 parameters."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with f32 statistics, result in x's dtype."""
    y = F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return _linear(F.gelu(_linear(x, self.fc1)), self.fc2)


class Attention(nn.Module):
    """Multi-head self-attention over the fused qkv projection.

    attn_impl 'auto' sends the (B, N, 3C) projection straight to the packed
    kernel on CUDA and to the plain version on the CPU; 'flash' takes the
    per-head kernel; 'plain' the eager reference on any device."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        d = c // self.num_heads
        qkv = _linear(x, self.qkv)
        if self.attn_impl == "auto" and qkv.is_cuda:
            out = packed_flash_attention(qkv, d)
        else:
            impl = "plain" if self.attn_impl == "auto" else self.attn_impl
            q, k, v = qkv.view(b, n, 3, self.num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
            out = multihead_attention(q, k, v, impl)  # (B, H, N, d)
            out = out.transpose(1, 2).reshape(b, n, c)
        return _linear(out, self.proj)


class Block(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, attn_impl: str = "auto"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(_layer_norm(x, self.norm1))
        return x + self.mlp(_layer_norm(x, self.norm2))


class PatchEmbed3D(nn.Module):
    """The reference's stride-p Conv3d, computed as patchify + matmul.

    The Conv3d holds the weight in the reference layout; the product runs as
    a matmul over (dz, dy, dx, c) rows, the JAX package's row order, and so
    stays out of cuDNN (whose f32 convolutions default to TF32)."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv3d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, volume: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = patchify(volume.to(dtype), self.patch_size)
        w = self.proj.weight.permute(0, 2, 3, 4, 1).reshape(self.proj.out_channels, -1)
        return F.linear(x, w.to(dtype), self.proj.bias.to(dtype))


class VisionTransformer3D(nn.Module):
    """Encoder-only 3D ViT for classification and feature extraction.

    `forward_features` returns the fc_norm'd mean over patch tokens when
    `global_pool`, else the normed cls token. Construct it on the `meta`
    device and load a state dict to avoid initialising weights that are
    about to be replaced (serving.py does so)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.in_chans, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.attn_impl) for _ in range(cfg.depth)
        )
        if cfg.global_pool:
            self.fc_norm = nn.LayerNorm(d, eps=1e-6)
        else:
            self.norm = nn.LayerNorm(d, eps=1e-6)
        if cfg.num_classes > 0:
            self.head = nn.Linear(d, cfg.num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x, self.dtype)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        if self.cfg.global_pool:
            return _layer_norm(x[:, 1:].mean(dim=1), self.fc_norm)
        return _layer_norm(x, self.norm)[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(x)
        if self.cfg.num_classes > 0:
            return _linear(feats, self.head)
        return feats
