"""MoCo-v3 comparison baseline (3D) in PyTorch.

Counterpart of the JAX package's models/moco.py (reference
other_baselines/mocov3/moco/builder.py:11-124): a ViT-3D (learned
pos-embed, cls token, no classifier) or ResNet-3D trunk, a projector
grafted in place of the trunk's classifier (3 layers for the ViT, 2 for the
ResNet, an affine-free BatchNorm last), a 2-layer predictor (its last
BatchNorm only for the ViT), the EMA update of the momentum encoder and the
symmetric InfoNCE loss with arange labels (`loss * 2T`; no all-gather, as
in the reference).

Modules follow the reference layout, so a model's state dict carries the
reference keys: the trunk is `base_encoder`, the projector sits at
`base_encoder.head` (ViT) or `base_encoder.fc` (ResNet), the predictor at
`predictor`, each head's layers at `_build_mlp`'s Sequential indices
(Linear 3l, BatchNorm1d 3l+1, ReLU 3l+2). The momentum encoder is a copy of
`base_encoder` (`momentum_encoder`), held by the training step.

Precision follows the JAX package: the heads' products run in the compute
dtype, their BatchNorm (flax's semantics, `FlaxBatchNorm`) in at least f32.
The ResNet trunk is built without a dtype there, so it stays f32 under any
compute dtype and only its heads follow it.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.models.resnet3d import ResNet3D, init_batchnorm, init_conv
from vit_ae_plus_plus_torch.models.vit import (
    FlaxBatchNorm,
    VisionTransformer3D,
    _linear,
    compute_dtype,
    init_heads,
    init_vit_trunk,
)
from vit_ae_plus_plus_torch.parallel import all_gather_batch, data_coords, get_mesh


class MoCoMLP(nn.Sequential):
    """`_build_mlp` (builder.py:36-52): [Linear(no bias) -> BatchNorm ->
    ReLU] x (n-1) -> Linear(no bias) [-> affine-free BatchNorm]. Products in
    `dtype`, BatchNorm in at least f32 (its output too)."""

    def __init__(self, num_layers: int, in_dim: int, mlp_dim: int, out_dim: int, last_bn: bool = True,
                 dtype: torch.dtype = torch.float32):
        layers = []
        for layer in range(num_layers):
            last = layer == num_layers - 1
            layers.append(nn.Linear(in_dim if layer == 0 else mlp_dim, out_dim if last else mlp_dim, bias=False))
            if not last:
                layers += [FlaxBatchNorm(mlp_dim), nn.ReLU()]
            elif last_bn:
                layers.append(FlaxBatchNorm(out_dim, affine=False))
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x):
        for layer in self:
            x = _linear(x.to(self.dtype), layer) if isinstance(layer, nn.Linear) else layer(x)
        return x


class _MoCo(nn.Module):
    """A MoCo model: `base_encoder` (trunk with the projector grafted in)
    and `predictor`. `forward(x, use_predictor)` is the JAX module's
    `__call__`; train or eval mode is the module's."""

    projector_name = "head"

    @property
    def projector(self) -> MoCoMLP:
        return getattr(self.base_encoder, self.projector_name)

    def encode(self, encoder: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """projector(trunk(x)) of `encoder` (the base encoder or its momentum
        copy)."""
        return getattr(encoder, self.projector_name)(encoder.forward_features(x))

    def forward(self, x: torch.Tensor, use_predictor: bool = False) -> torch.Tensor:
        z = self.encode(self.base_encoder, x)
        return self.predictor(z) if use_predictor else z

    def trunk_features(self, x: torch.Tensor) -> torch.Tensor:
        """The projector-free trunk features that the reference extracts
        (main_extract_ssl_features.py:184-195)."""
        return self.base_encoder.forward_features(x)

    def momentum_encoder(self) -> nn.Module:
        """A copy of `base_encoder`, its parameters and BatchNorm statistics
        included: the momentum encoder at the start of training."""
        enc = copy.deepcopy(self.base_encoder)
        for p in enc.parameters():
            p.requires_grad_(False)
        return enc

    def _init_heads(self, generator: torch.Generator) -> None:
        """The heads' init in the JAX package (`init_heads`), the projector
        first."""
        init_heads([*self.projector, *self.predictor], generator)


class MoCoViT3D(_MoCo):
    """ViT trunk (builder.py:113-124): `VisionTransformer3D` without a
    classifier, features the normed cls token (global_pool off), a 3-layer
    projector and a 2-layer predictor, both with the last BatchNorm."""

    def __init__(self, cfg: ViTConfig, dim: int = 256, mlp_dim: int = 4096):
        super().__init__()
        cfg = dataclasses.replace(cfg, num_classes=0)
        dt = compute_dtype(cfg.dtype)
        self.base_encoder = VisionTransformer3D(cfg)
        self.base_encoder.head = MoCoMLP(3, cfg.embed_dim, mlp_dim, dim, last_bn=True, dtype=dt)
        self.predictor = MoCoMLP(2, dim, mlp_dim, dim, last_bn=True, dtype=dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoCoViT3D":
        """The JAX package's init: the trunk as `init_vit_trunk` (the
        projector's Linear layers left to `_init_heads`), the heads as
        `_init_heads`."""
        init_vit_trunk(self.base_encoder, generator, skip=set(self.projector.modules()))
        self._init_heads(generator)
        return self


class MoCoResNet3D(_MoCo):
    """ResNet trunk (MoCo_ResNet, builder.py:101-111): a 2-layer projector in
    place of `fc` and, unlike the ViT variant, a 2-layer predictor without
    the last BatchNorm. The trunk is f32 whatever `dtype` (the JAX package
    builds it without one); the heads compute in `dtype`."""

    projector_name = "fc"

    def __init__(self, depth: int = 10, dim: int = 256, mlp_dim: int = 4096, dtype: str = "float32",
                 in_channels: int = 1):
        super().__init__()
        dt = compute_dtype(dtype)
        self.base_encoder = ResNet3D(depth=depth, in_channels=in_channels)
        hidden = self.base_encoder.fc.in_features
        self.base_encoder.fc = MoCoMLP(2, hidden, mlp_dim, dim, last_bn=True, dtype=dt)
        self.predictor = MoCoMLP(2, dim, mlp_dim, dim, last_bn=False, dtype=dt)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MoCoResNet3D":
        """The trunk's convolutions and BatchNorms as `ResNet3D.init_weights`,
        the heads as `_init_heads`."""
        head_modules = set(self.projector.modules())
        for m in self.base_encoder.modules():
            if m in head_modules:
                continue
            if isinstance(m, nn.Conv3d):
                init_conv(m, generator)
            elif isinstance(m, FlaxBatchNorm):
                init_batchnorm(m)
        self._init_heads(generator)
        return self


@torch.no_grad()
def ema_update(momentum: list, base: list, m: float) -> None:
    """momentum = momentum * m + base * (1 - m), in place, over matching
    lists of tensors (builder.py:57-61). `m` is rounded to f32 first, as
    the JAX package passes it (`jnp.float32(m)`), so 1 - m is exact. On an
    FSDP state both lists hold this rank's blocks, the momentum tree in the
    base tree's placement (parallel/fsdp.py `shard_moco_state_fsdp`)."""
    m = float(torch.tensor(m, dtype=torch.float32))
    torch._foreach_mul_(momentum, m)
    torch._foreach_add_(momentum, torch._foreach_mul(base, 1.0 - m))


def info_nce(q: torch.Tensor, k: torch.Tensor, temperature: float = 1.0, first_label: int = 0) -> torch.Tensor:
    """InfoNCE (builder.py:63-75): the cross-entropy of the cosine logits of
    the queries `q` (b, dim) against the keys `k` (B, dim) over T, the label
    of query i the key first_label + i, times 2T. One process: B = b and
    the labels arange(b)."""
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    k = k / torch.linalg.vector_norm(k, dim=1, keepdim=True)
    dt = torch.promote_types(q.dtype, k.dtype)
    logits = (q.to(dt) @ k.to(dt).T) / temperature
    labels = first_label + torch.arange(logits.shape[0], device=logits.device)
    return F.cross_entropy(logits, labels) * (2.0 * temperature)


def moco_loss(model: _MoCo, momentum_encoder: nn.Module, x1: torch.Tensor, x2: torch.Tensor,
              temperature: float = 1.0) -> torch.Tensor:
    """The symmetric MoCo-v3 objective (builder.py:77-98) in training mode:
    queries through the base encoder and the predictor, x1 then x2 (x2's
    pass sees the running statistics x1's pass moved), keys through the
    momentum encoder on batch statistics without gradients. The key
    passes move the momentum encoder's running statistics too; the caller
    restores them (the JAX package discards those updates). Under a data
    mesh, x1 and x2 are this rank's rows and the keys are the global
    batch's (module docstring)."""
    model.train()
    momentum_encoder.train()
    q1 = model(x1, use_predictor=True)
    q2 = model(x2, use_predictor=True)
    with torch.no_grad():
        k1 = model.encode(momentum_encoder, x1)
        k2 = model.encode(momentum_encoder, x2)
    d, size = data_coords()
    first = 0
    if size > 1:
        keys = all_gather_batch(torch.cat([k1, k2], dim=1), get_mesh())
        k1, k2 = keys.split(k1.shape[1], dim=1)
        first = d * q1.shape[0]
    return info_nce(q1, k2, temperature, first) + info_nce(q2, k1, temperature, first)
