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
(`FlaxBatchNorm`).

`VisionTransformer3DContrastive` is the two-view contrastive model that
`contrastive-train` trains: a headless trunk and `ContrastiveHeads` (a
predictor, and optionally a projector), the JAX package's module of that
name.

A block's LayerNorms run one of three ways, as in the JAX package:
`ln_fusion="on"` fuses norm1 into attn.qkv and norm2 into mlp.fc1
(kernels/fused_ln_dense.py; 'auto' never fuses), `ln_dtype="bfloat16"`
computes their statistics in bf16 (`ln_stats_dtype`), and the default is
the unfused LayerNorm with f32 statistics. Parameter names are the same in
all three, so one state dict loads into any of them.

The sharded training state (parallel/tp.py, parallel/fsdp.py) hooks in
here. Under tensor parallelism (`Attention.tp`, `Mlp.tp`) the qkv and fc1
hold this rank's heads or hidden units, the proj and fc2 its rows of the
input dim: the input of qkv and fc1 goes through `copy_to_model`, the
partial products of proj and fc2 through `reduce_from_model`, and their
biases are added after the sum; a fused LayerNorm falls back to the
unfused pair, as in the JAX package. Under FSDP a `Block` (`fsdp_unit`)
and a Linear outside the blocks gather their 'data'-sharded leaves at
their use (`Block.fsdp`, `_linear`: parallel/fsdp.py `gathered_call`).
"""

from __future__ import annotations

import dataclasses
import math
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
from vit_ae_plus_plus_torch.parallel import get_mesh, psum
from vit_ae_plus_plus_torch.parallel.fsdp import gathered_call
from vit_ae_plus_plus_torch.parallel.tp import copy_to_model, reduce_from_model

# float64 serves the CPU trajectory tests, as in the JAX package
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute dtype must be one of {sorted(_DTYPES)}, got {name!r}")
    return _DTYPES[name]


def _dense(x: torch.Tensor, weight: torch.Tensor, bias) -> torch.Tensor:
    """x W^T + b in x's dtype over f32 parameters, rounded where flax's Dense
    rounds: below f32 the product is rounded to x's dtype before the bias
    is added (two roundings, where a bias fused into the product makes
    one); in f32 and f64 the fused bias differs from that by one rounding
    of the sum and saves a pass."""
    w = weight.to(x.dtype)
    if bias is None:
        return F.linear(x, w)
    if x.dtype.itemsize < 4:
        return F.linear(x, w) + bias.to(x.dtype)
    return F.linear(x, w, bias.to(x.dtype))


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """Dense in x's dtype over f32 parameters (`_dense`); a Linear whose
    leaves are sharded over 'data' gathers them for the call."""
    if getattr(layer, "fsdp", None):
        return gathered_call(layer, lambda t: _dense(t, layer.weight, layer.bias), x)
    return _dense(x, layer.weight, layer.bias)


def _row_parallel(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A row-parallel Dense: this rank's partial product of its rows of the
    input dim, rounded where `_dense` rounds it, summed over 'model', then
    the bias."""
    mesh = get_mesh()
    out = reduce_from_model(F.linear(x, layer.weight.to(x.dtype)), mesh)
    return out + layer.bias.to(x.dtype)


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
    tp = False  # tensor parallel: fc1 column-, fc2 row-parallel over 'model'

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x, ln: nn.LayerNorm = None):
        """`ln`: when given, x is the un-normalised stream and `ln` is fused
        into fc1."""
        if self.tp:
            h = F.gelu(_linear(copy_to_model(x, get_mesh()), self.fc1))
            return _row_parallel(h, self.fc2)
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
    fused into qkv. With `tp`, qkv holds this rank's H / M heads and proj
    its rows (module docstring)."""

    tp = False

    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, ln: nn.LayerNorm = None, impl: str = None):
        """`impl` overrides `attn_impl` for this call (the pipeline's
        stages, parallel/pp.py `make_block_apply`)."""
        b, n, c = x.shape
        d = c // self.num_heads
        impl = self.attn_impl if impl is None else impl
        if self.tp:
            x = copy_to_model(x, get_mesh())
        qkv = _linear(x, self.qkv) if ln is None else _ln_dense(x, ln, self.qkv)
        heads = qkv.shape[-1] // (3 * d)  # this rank's, under tp
        if impl == "auto" and qkv.is_cuda:
            out = packed_flash_attention(qkv, d)
        else:
            impl = "plain" if impl == "auto" else impl
            q, k, v = qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)
            out = multihead_attention(q, k, v, impl)  # (B, H, N, d)
            out = out.transpose(1, 2).reshape(b, n, heads * d)
        return _row_parallel(out, self.proj) if self.tp else _linear(out, self.proj)


class Block(nn.Module):
    """Pre-LN transformer block, its LayerNorms fused (`ln_fusion="on"`),
    with bf16 statistics (`ln_dtype="bfloat16"`) or plain. Under FSDP the
    unit that gathers its leaves: `fsdp` {leaf name: sharded dim}."""

    fsdp_unit = True
    fsdp = None

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

    def forward(self, x, attn_impl: str = None):
        """`attn_impl` overrides the attention's own for this call."""
        if self.fsdp:
            return gathered_call(self, self._forward, x, attn_impl)
        return self._forward(x, attn_impl)

    def _forward(self, x, attn_impl=None):
        if self.fused and not self.attn.tp:  # under TP, the unfused pair (kernel #7 holds the whole W)
            x = x + self.attn(x, ln=self.norm1, impl=attn_impl)
            return x + self.mlp(x, ln=self.norm2)
        x = x + self.attn(self._norm(x, self.norm1), impl=attn_impl)
        return x + self.mlp(self._norm(x, self.norm2))


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, blocks_fn=None) -> torch.Tensor:
    """The blocks in turn, or `blocks_fn(blocks, x)`."""
    if blocks_fn is not None:
        return blocks_fn(blocks, x)
    for blk in blocks:
        x = blk(x)
    return x


def patch_embed_matrix(weight: torch.Tensor) -> torch.Tensor:
    """The patch embed's Conv3d weight (D, C, p, p, p) as the (D, p^3 C)
    matrix over patchify's (dz, dy, dx, c) rows."""
    return weight.permute(0, 2, 3, 4, 1).reshape(weight.shape[0], -1)


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
        return _dense(x, patch_embed_matrix(self.proj.weight), self.proj.bias)


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

    def forward_features(self, x: torch.Tensor, blocks_fn=None) -> torch.Tensor:
        """`blocks_fn(blocks, x)`, when given, runs the block stack in place
        of the loop (the GPipe pipeline, parallel/pp.py)."""
        x = self.patch_embed(x, self.dtype)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = run_blocks(self.blocks, x, blocks_fn)
        if self.cfg.global_pool:
            return _layer_norm(x[:, 1:].mean(dim=1), self.fc_norm)
        return _layer_norm(x, self.norm)[:, 0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(x)
        if self.cfg.num_classes > 0:
            return _linear(feats, self.head)
        return feats


class FlaxBatchNorm(nn.Module):
    """BatchNorm over dim 1 (the features of (M, D), the channels of
    (N, C, D, H, W)) with flax's semantics, which the JAX package trains
    with: the running statistics move as `0.9 * running + 0.1 * batch`
    (flax momentum 0.9), the running variance is the BIASED batch variance
    (torch's BatchNorm keeps the unbiased one), eps 1e-5, and the batch
    variance is E[x^2] - E[x]^2 over every dim but 1, clipped at 0.
    Statistics and output are in at least f32. Trains on batch statistics
    and updates the running ones in `training` mode, normalises with the
    running ones otherwise.

    Under an ambient mesh whose 'data' axis has more than one rank, the
    batch statistics are the global batch's, as the JAX step takes them
    over a batch sharded `P('data')`: the rows' sums, sums of squares and
    count go through one differentiable all-reduce (`parallel.psum`), so
    every rank normalises with, and moves its running statistics by, the
    same moments."""

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
        dims = [0, *range(2, x.ndim)]
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            xf = x.to(dt)
            mesh = get_mesh()
            if mesh is not None and mesh.size("data") > 1:
                count = torch.full((1,), xf.numel() // xf.shape[1], dtype=dt, device=x.device)
                sums = psum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]), mesh, "data")
                c = xf.shape[1]
                mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
            else:
                mean, mean_sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean.to(dt), self.running_var.to(dt)
        mul = torch.rsqrt(var + self.eps)
        if self.affine:
            mul = mul * self.weight
        y = (x - mean.view(shape)) * mul.view(shape)
        return y + self.bias.view(shape) if self.affine else y


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
            layers += [nn.Linear(dim, dim, bias=False), FlaxBatchNorm(dim), nn.ReLU()]
        if final_dense:
            layers.append(nn.Linear(dim, dim))
        else:
            layers += [nn.Linear(dim, dim, bias=False), FlaxBatchNorm(dim, affine=False)]
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x):
        for layer in self:
            x = _linear(x.to(self.dtype), layer) if isinstance(layer, nn.Linear) else layer(x)
        return x


class ContrastiveHeads(nn.Module):
    """The predictor (`MLPHead`, one hidden layer and a biased Linear) and,
    with `use_proj`, the projector (two hidden layers, a bias-free Linear
    and an affine-free BatchNorm) of two-view contrastive training (the
    JAX package's `ContrastiveHeads`, reference model/vit.py:301-337). The
    projector, where it exists, is applied to both views before the
    predictor."""

    def __init__(self, dim: int, use_proj: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_proj = use_proj
        if use_proj:
            self.projector = MLPHead(dim, num_hidden=2, final_dense=False, dtype=dtype)
        self.predictor = MLPHead(dim, num_hidden=1, final_dense=True, dtype=dtype)

    def forward(self, z1: torch.Tensor, z2: torch.Tensor):
        if self.use_proj:
            z1, z2 = self.projector(z1), self.projector(z2)
        return self.predictor(z1), self.predictor(z2), z1, z2


class VisionTransformer3DContrastive(nn.Module):
    """The classifier trunk with SimSiam heads (JAX package
    `VisionTransformer3DContrastive`): z = trunk(x) for each view, the
    projector when `use_proj`, the predictor; `forward(x1, x2)` returns
    (p1, p2, z1, z2) with z1 and z2 detached. The trunk is built headless
    (num_classes 0), the only setting in which the reference's heads at
    embed_dim can run. Train or eval mode is the module's (the heads'
    BatchNorm). State dict: `trunk.*` and `heads.predictor.*` /
    `heads.projector.*` at `MLPHead`'s Sequential indices."""

    def __init__(self, cfg: ViTConfig, use_proj: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_proj = use_proj
        self.trunk = VisionTransformer3D(dataclasses.replace(cfg, num_classes=0))
        self.heads = ContrastiveHeads(cfg.embed_dim, use_proj, compute_dtype(cfg.dtype))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        p1, p2, z1, z2 = self.heads(self.trunk(x1), self.trunk(x2))
        return p1, p2, z1.detach(), z2.detach()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VisionTransformer3DContrastive":
        """The JAX package's init: the trunk as `init_vit_trunk`, the heads as
        `init_heads`."""
        init_vit_trunk(self.trunk, generator)
        init_heads(self.heads.modules(), generator)
        return self


@torch.no_grad()
def init_vit_trunk(trunk: VisionTransformer3D, generator: torch.Generator, skip=frozenset()) -> None:
    """The JAX package's init of a ViT trunk, drawn from `generator`: the
    Linear weights (but those of `skip`, a set of modules) and the patch
    embed (as its (p^3 C, D) matrix) xavier-uniform with zero biases,
    cls_token and pos_embed N(0, 0.02), LayerNorm 1 / 0."""
    for m in trunk.modules():
        if isinstance(m, nn.Linear) and m not in skip:
            fan_out, fan_in = m.weight.shape
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            m.weight.uniform_(-lim, lim, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    w = trunk.patch_embed.proj.weight
    lim = math.sqrt(6.0 / (w[0].numel() + w.shape[0]))
    w.uniform_(-lim, lim, generator=generator)
    trunk.patch_embed.proj.bias.zero_()
    for t in (trunk.cls_token, trunk.pos_embed):
        t.normal_(0.0, 0.02, generator=generator)


@torch.no_grad()
def init_heads(modules, generator: torch.Generator) -> None:
    """The JAX package's init of SimSiam and MoCo heads, over `modules` in
    order: each Linear uniform with variance 1 / (3 fan_in) (torch's Linear
    default, `torch_linear_init`) and a zero bias, each BatchNorm at scale
    1, bias 0, mean 0, variance 1."""
    for m in modules:
        if isinstance(m, nn.Linear):
            lim = math.sqrt(1.0 / m.weight.shape[1])
            m.weight.uniform_(-lim, lim, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FlaxBatchNorm):
            if m.affine:
                m.weight.fill_(1.0)
                m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
