"""3D ResNet supervised baseline in PyTorch.

Counterpart of the JAX package's models/resnet3d.py (reference
k_fold_training_scripts/resnet_3d.py:1-243, the Kataoka 3D-ResNet family):
conv1 (7,7,7) with stride (1,2,2) and padding 3, max-pool 3 / 2 / 1 (padded
with -inf, as flax pads), four stages of Basic or Bottleneck blocks,
shortcut "B" (a 1x1x1 convolution and BatchNorm where the shape changes),
the mean over the volume, the fc head; depths 10/18/34/50/101/152/200.
NCDHW tensors throughout. Parameter names are the reference's (`conv1`,
`bn1`, `layer{s}.{b}.conv1`, `layer{s}.{b}.downsample.0`, `fc`), so the
state dict is the reference layout.

Precision follows the JAX package's declared rounding: parameters stay
f32; every convolution and the head run in the compute dtype (weights cast
per call, the output rounded to it, the head's bias added after its
product); BatchNorm (`FlaxBatchNorm`, flax's semantics) computes its
statistics and output in at least f32, so the activations between blocks
are f32 under bf16.

cuDNN may run f32 convolutions on the TF32 tensor cores
(`torch.backends.cudnn.allow_tf32` is True by default), which the f32
model must not: `conv_precision()` turns TF32 off for the length of a
`with` block, around the forward here and around the backward in the
training steps (pipelines/resnet_kfold.py, pipelines/moco_kfold.py), and
leaves the process-wide flag as it was.

The port's own init (`init_weights`) draws the JAX package's
distributions from a `torch.Generator` (variance-scaling 2.0 over fan-out,
truncated normal, for the convolutions; flax's default Dense, LeCun
truncated normal and zero bias, for the head); the numbers differ from
JAX's (ROADMAP Queue 3), which the parity tests inject through
`train.checkpoint.params_from_jax`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vit_ae_plus_plus_torch.models.vit import FlaxBatchNorm, compute_dtype

# std of the standard normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def conv_precision():
    """A context in which cuDNN computes f32 convolutions in f32 (no TF32),
    every other cuDNN setting kept."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                       allow_tf32=False)


def conv_plain(x: torch.Tensor, weight: torch.Tensor, stride, padding, dtype: torch.dtype) -> torch.Tensor:
    """A convolution in `dtype` as the JAX package declares it: the operands
    rounded to `dtype`, the products summed in at least f32, the output
    rounded to `dtype` (flax's `Conv(dtype=...)` with XLA's excess precision
    off). Under bf16 it equals what a bf16 convolution that accumulates in
    f32 computes, up to the order of the sums."""
    wide = torch.promote_types(dtype, torch.float32)
    return F.conv3d(x.to(dtype).to(wide), weight.to(dtype).to(wide), None, stride, padding).to(dtype)


def _conv(x: torch.Tensor, conv: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """Conv3d in `dtype` over f32 weights: cuDNN's on the card, `conv_plain`
    on the CPU, where torch's own bf16 conv3d returns a weight gradient that
    changes from call to call at some shapes (torch 2.13: a 3x3x3 kernel of
    stride 2 over a 2x1x1 input, as ResNet-10's layer4 sees at 16^3)."""
    if x.device.type == "cpu":
        return conv_plain(x, conv.weight, conv.stride, conv.padding, dtype)
    return F.conv3d(x.to(dtype), conv.weight.to(dtype), None, conv.stride, conv.padding)


def _shortcut(in_planes: int, out_planes: int, stride: int):
    """Shortcut "B": a 1x1x1 convolution and BatchNorm where the shape
    changes, None (identity) where it does not."""
    if stride == 1 and in_planes == out_planes:
        return None
    return nn.Sequential(nn.Conv3d(in_planes, out_planes, 1, stride, bias=False), FlaxBatchNorm(out_planes))


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(in_planes, planes, 3, stride, 1, bias=False)
        self.bn1 = FlaxBatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FlaxBatchNorm(planes)
        self.downsample = _shortcut(in_planes, planes, stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        y = self.bn2(_conv(y, self.conv2, dtype))
        residual = x if self.downsample is None else self.downsample[1](_conv(x, self.downsample[0], dtype))
        return F.relu(y + residual)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = nn.Conv3d(in_planes, planes, 1, bias=False)
        self.bn1 = FlaxBatchNorm(planes)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FlaxBatchNorm(planes)
        self.conv3 = nn.Conv3d(planes, out_planes, 1, bias=False)
        self.bn3 = FlaxBatchNorm(out_planes)
        self.downsample = _shortcut(in_planes, out_planes, stride)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        y = F.relu(self.bn2(_conv(y, self.conv2, dtype)))
        y = self.bn3(_conv(y, self.conv3, dtype))
        residual = x if self.downsample is None else self.downsample[1](_conv(x, self.downsample[0], dtype))
        return F.relu(y + residual)


DEPTH_CONFIGS = {
    10: (BasicBlock3D, (1, 1, 1, 1)),
    18: (BasicBlock3D, (2, 2, 2, 2)),
    34: (BasicBlock3D, (3, 4, 6, 3)),
    50: (Bottleneck3D, (3, 4, 6, 3)),
    101: (Bottleneck3D, (3, 4, 23, 3)),
    152: (Bottleneck3D, (3, 8, 36, 3)),
    200: (Bottleneck3D, (3, 24, 36, 3)),
}
INPLANES = (64, 128, 256, 512)


class ResNet3D(nn.Module):
    """generate_model equivalent (resnet_3d.py:216-242). `forward(x)` takes
    (N, C, D, H, W) and returns (N, n_classes) logits in the compute dtype;
    train or eval mode is the module's."""

    def __init__(self, depth: int = 10, n_classes: int = 2, widen_factor: float = 1.0, no_max_pool: bool = False,
                 dtype: str = "float32", in_channels: int = 1):
        super().__init__()
        if depth not in DEPTH_CONFIGS:
            raise ValueError(f"invalid depth {depth}")
        block_cls, layers = DEPTH_CONFIGS[depth]
        self.no_max_pool, self.dtype = no_max_pool, compute_dtype(dtype)
        planes = int(INPLANES[0] * widen_factor)
        self.conv1 = nn.Conv3d(in_channels, planes, 7, (1, 2, 2), 3, bias=False)
        self.bn1 = FlaxBatchNorm(planes)
        in_planes = planes
        for stage, (width, n_blocks) in enumerate(zip(INPLANES, layers)):
            planes = int(width * widen_factor)
            blocks = []
            for b in range(n_blocks):
                blocks.append(block_cls(in_planes, planes, 2 if (stage > 0 and b == 0) else 1))
                in_planes = planes * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_planes, n_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """The pooled (N, C) features, in at least f32."""
        with conv_precision():
            x = F.relu(self.bn1(_conv(x, self.conv1, self.dtype)))
            if not self.no_max_pool:
                x = F.max_pool3d(x, 3, 2, 1)
            for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
                for block in stage:
                    x = block(x, self.dtype)
            return x.mean(dim=(2, 3, 4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's Dense: the product in the compute dtype, then the bias added
        # in it (under bf16 two roundings, where a fused bias makes one)
        features = self.forward_features(x).to(self.dtype)
        return F.linear(features, self.fc.weight.to(self.dtype)) + self.fc.bias.to(self.dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers, drawn on the host from
        `generator` in module order: each convolution as `init_conv`, the
        head a normal truncated at two deviations with variance 1 / fan-in
        and a zero bias, BatchNorm as `init_batchnorm`."""
        for module in self.modules():
            if isinstance(module, nn.Conv3d):
                init_conv(module, generator)
            elif isinstance(module, nn.Linear):
                module.bias.zero_()
                _trunc_normal(module.weight, math.sqrt(1.0 / module.weight.shape[1]), generator)
            elif isinstance(module, FlaxBatchNorm):
                init_batchnorm(module)


def _trunc_normal(weight: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """`weight` <- a normal of deviation `std` truncated at two deviations
    (jax.nn.initializers' truncated normal), drawn on the host."""
    w = torch.empty(weight.shape)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.copy_(std / _TRUNC_STD * w)


@torch.no_grad()
def init_conv(conv: nn.Conv3d, generator: torch.Generator) -> None:
    """A convolution's init in the JAX package: truncated normal with
    variance 2 / fan-out (fan-out = out channels x kernel volume)."""
    fan_out = conv.weight.shape[0] * math.prod(conv.weight.shape[2:])
    _trunc_normal(conv.weight, math.sqrt(2.0 / fan_out), generator)


@torch.no_grad()
def init_batchnorm(bn: FlaxBatchNorm) -> None:
    """BatchNorm at its identity: scale 1, bias 0, mean 0, variance 1."""
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)


def generate_model(model_depth: int, n_classes: int = 2, n_input_channels: int = 1, **kw) -> ResNet3D:
    """Reference-compatible constructor (resnet_3d.py:216)."""
    if model_depth not in DEPTH_CONFIGS:
        raise ValueError(f"invalid depth {model_depth}")
    return ResNet3D(depth=model_depth, n_classes=n_classes, in_channels=n_input_channels, **kw)
