"""3D Vision Transformer trunk in PyTorch.

Counterpart of the JAX package's models/vit.py: pre-LN blocks
`x + attn(LN(x))`, `x + mlp(LN(x))`, LayerNorm eps 1e-6, qkv bias, exact-erf
GELU MLP. Parameter names are the reference PyTorch keys
(`patch_embed.proj.weight` as a Conv3d weight (D, C, p, p, p),
`blocks.N.attn.qkv.weight`, `blocks.N.mlp.fc1.weight`, `fc_norm.weight`, ...).

Precision follows the JAX package: parameters stay f32; every product runs
in the compute dtype (weights are cast per call); LayerNorm statistics are
at least f32 and the result is cast back; attention's softmax is at least
f32 (kernels/). The contrastive heads' BatchNorm follows flax, not torch
(`FlaxBatchNorm1d`).

A block's LayerNorms run one of three ways, as in the JAX package:
`ln_fusion="on"` fuses norm1 into attn.qkv and norm2 into mlp.fc1
(kernels/fused_ln_dense.py; 'auto' never fuses), `ln_dtype="bfloat16"`
computes their statistics in bf16 (`ln_stats_dtype`), and the default is
the unfused LayerNorm with f32 statistics. Parameter names are the same in
all three, so one state dict loads into any of them.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
from torch import nn

from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.configs.config import check_ln_fusion
from vit_ae_plus_plus_torch.kernels import (
    fused_layernorm,
    fused_ln_dense,
    multihead_attention,
    packed_flash_attention,
)
from vit_ae_plus_plus_torch.ops import patchify

# float64 serves the CPU trajectory tests, as in the JAX package
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Dense in x's dtype over f32 parameters."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with at least f32 statistics, result in x's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    y = F.layer_norm(x.to(dt), norm.normalized_shape, norm.weight.to(dt), norm.bias.to(dt), norm.eps)
    return y.to(x.dtype)


def _use_fused_ln(mode: str) -> bool:
    """The JAX package's gate for the fused LN+Dense kernel: 'on' fuses,
    'off' and 'auto' do not ('auto' stays unfused: the fused step measured
    slower in-model, on a TPU and on an H100, PERF.md); anything else
    raises."""
    check_ln_fusion(mode)
    return mode == "on"


def _ln_dense(x: torch.Tensor, norm: nn.LayerNorm, layer: nn.Linear) -> torch.Tensor:
    """Dense(LayerNorm(x)) through the fused kernel; x is the un-normalised
    stream in the compute dtype."""
    return fused_ln_dense(x, norm.weight, norm.bias, layer.weight, layer.bias, norm.eps)


def ln_stats_dtype(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with statistics, normalisation and affine all in `dtype`
    (the opt-in `ln_dtype="bfloat16"`), result in `dtype`. Two-pass
    variance: E[x^2] - mean^2 cancels catastrophically in bf16."""
    xd = x.to(dtype)
    mu = xd.mean(dim=-1, keepdim=True)
    d = xd - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + torch.tensor(norm.eps, dtype=dtype))
    return y * norm.weight.to(dtype) + norm.bias.to(dtype)


class FusedLayerNorm(nn.Module):
    """LayerNorm through the LayerNorm kernels (kernels/fused_ln.py): a
    drop-in that no trunk uses, as in the JAX package. Parameters `weight`
    and `bias` (flax's `scale` and `bias`); the result is cast to `dtype`."""

    def __init__(self, dim: int, eps: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layernorm(x, self.weight, self.bias, self.eps).to(self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x, ln: nn.LayerNorm = None):
        """`ln`: when given, x is the un-normalised stream and `ln` is fused
        into fc1."""
        h = _linear(x, self.fc1) if ln is None else _ln_dense(x, ln, self.fc1)
        return _linear(F.gelu(h), self.fc2)


class Attention(nn.Module):
    """Multi-head self-attention over the fused qkv projection.

    attn_impl 'auto' sends the (B, N, 3C) projection straight to the packed
    kernels on CUDA (a head dim or dtype they are not built for raises) and
    to the plain version on the CPU; 'flash' takes the per-head kernels;
    'plain' the eager reference on any device; 'flash_ring' and
    'flash_seq' the per-head layout too, sharding the sequence over the
    ambient mesh (`parallel.set_mesh`; without one they are 'flash'). Every
    path is differentiable: the kernels' backward runs in
    csrc/flash_bwd.cu. With `ln`, x is the un-normalised stream and `ln` is
    fused into qkv."""

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ln: nn.LayerNorm = None):
        b, n, c = x.shape
        d = c // self.num_heads
        qkv = _linear(x, self.qkv) if ln is None else _ln_dense(x, ln, self.qkv)
        if self.attn_impl == "auto" and qkv.is_cuda:
            out = packed_flash_attention(qkv, d)
        else:
            impl = "plain" if self.attn_impl == "auto" else self.attn_impl
            q, k, v = qkv.view(b, n, 3, self.num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
            out = multihead_attention(q, k, v, impl)  # (B, H, N, d)
            out = out.transpose(1, 2).reshape(b, n, c)
        return _linear(out, self.proj)


class Block(nn.Module):
    """Pre-LN transformer block, its LayerNorms fused (`ln_fusion="on"`),
    with bf16 statistics (`ln_dtype="bfloat16"`) or plain."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, attn_impl: str = "auto",
                 ln_fusion: str = "auto", ln_dtype: str = "float32"):
        super().__init__()
        self.fused = _use_fused_ln(ln_fusion)
        self.low_ln = ln_dtype == "bfloat16"
        if self.fused and self.low_ln:
            warnings.warn(
                "ln_fusion='on' routes LayerNorm through the fused LN+Dense "
                "kernel, whose statistics are f32: ln_dtype='bfloat16' is "
                "ignored on fused blocks; drop one of the two flags",
                stacklevel=2,
            )
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def _norm(self, x, norm):
        if self.low_ln:  # the stream's dtype again: the Dense layers compute in it
            return ln_stats_dtype(x, norm, torch.bfloat16).to(x.dtype)
        return _layer_norm(x, norm)

    def forward(self, x):
        if self.fused:
            x = x + self.attn(x, ln=self.norm1)
            return x + self.mlp(x, ln=self.norm2)
        x = x + self.attn(self._norm(x, self.norm1))
        return x + self.mlp(self._norm(x, self.norm2))


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
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.attn_impl, cfg.ln_fusion, cfg.ln_dtype)
            for _ in range(cfg.depth)
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


class FlaxBatchNorm1d(nn.Module):
    """BatchNorm over the rows of (M, D) with flax's semantics, which the JAX
    package trains with: the running statistics move as
    `0.9 * running + 0.1 * batch` (flax momentum 0.9), the running variance
    is the BIASED batch variance (torch's BatchNorm1d keeps the unbiased
    one), eps 1e-5, and the batch variance is E[x^2] - E[x]^2 clipped at 0.
    Statistics and output are in at least f32. Trains on batch statistics
    and updates the running ones in `training` mode, normalises with the
    running ones otherwise."""

    momentum = 0.9
    eps = 1e-5

    def __init__(self, dim: int, affine: bool = True):
        super().__init__()
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(torch.promote_types(x.dtype, torch.float32), self.running_mean.dtype)
        if self.training:
            xf = x.to(dt)
            mean = xf.mean(dim=0)
            var = torch.clamp_min((xf * xf).mean(dim=0) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight
        y = (x - mean) * mul
        return y + self.bias if self.affine else y


class MLPHead(nn.Sequential):
    """SimSiam head: [Linear(no bias) -> BatchNorm -> ReLU] x num_hidden,
    then a biased Linear (the predictor), or a bias-free Linear and an
    affine-free BatchNorm (the projector). The layers sit at the reference's
    Sequential indices (predictor.{0,1,3}, projection_head.{0,1,3,4,6,7}).

    Linear products run in the compute dtype; BatchNorm, as flax's with
    `dtype=None`, in at least f32 (models/vit.py MLPHead of the JAX
    package)."""

    def __init__(self, dim: int, num_hidden: int = 1, final_dense: bool = True,
                 dtype: torch.dtype = torch.float32):
        layers = []
        for _ in range(num_hidden):
            layers += [nn.Linear(dim, dim, bias=False), FlaxBatchNorm1d(dim), nn.ReLU()]
        if final_dense:
            layers.append(nn.Linear(dim, dim))
        else:
            layers += [nn.Linear(dim, dim, bias=False), FlaxBatchNorm1d(dim, affine=False)]
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x):
        for layer in self:
            x = _linear(x.to(self.dtype), layer) if isinstance(layer, nn.Linear) else layer(x)
        return x
