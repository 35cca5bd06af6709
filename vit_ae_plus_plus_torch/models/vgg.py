"""VGG16 perceptual loss: the port's copy of the JAX package's models/vgg.py.

Parity: reference model/model_utils/perceptual_loss.py:11-84 (torchvision's
VGG16 `features` sliced at relu1_2 / relu2_2 / relu3_3 / relu4_3, indices
0-3 / 4-8 / 9-15 / 16-22); volumes folded depth-into-batch as 2D slices
(:48-49), a single channel repeated to three (:50-51), the per-input-channel
loss averaged (:72-77), and the MSE over the four taps averaged.

`VGG16Features` is built by hand from `nn.Conv2d` and `F.max_pool2d`
(torchvision is on neither machine), as `convs.0` ... `convs.9`, the ten
3x3 convolutions up to relu4_3. It runs in f32 whatever the training
step's dtype (the JAX module's default dtype), and on the card under
`resnet3d.conv_precision()`: cuDNN allows TF32 for f32 convolutions by
default, and a TF32 VGG is another function.

Weights: the reference loads torchvision's ImageNet VGG16 or its own SSL
checkpoint; `build_perceptual(vgg_ckpt)` reads such a checkpoint's state
dict (`features.{0,2,5,7,10,12,14,17,19,21}`, torch's own layout, so no
transpose). Without one it draws seeded random weights from flax's default
`Conv` initialiser (LeCun normal, zero bias), the distribution the JAX
package draws from, with the JAX package's warning: a fixed random
projection, not the reference's pretrained loss. The default
`perceptual_weight=0` (config.ini:34) leaves the term off.
"""

from __future__ import annotations

import math
import pickle
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ae_plus_plus_torch.device import resolve_device
from vit_ae_plus_plus_torch.models.resnet3d import conv_precision

# (out_channels, pool_before) per conv in torchvision's vgg16.features order,
# up to index 22 (relu4_3), one tuple per tap
_VGG_SLICES: Tuple[Tuple[Tuple[int, bool], ...], ...] = (
    ((64, False), (64, False)),                 # conv1_1, conv1_2 -> relu1_2
    ((128, True), (128, False)),                # pool, conv2_1, conv2_2 -> relu2_2
    ((256, True), (256, False), (256, False)),  # pool, conv3_1..3 -> relu3_3
    ((512, True), (512, False), (512, False)),  # pool, conv4_1..3 -> relu4_3
)
# torchvision's `features` index of each conv
TORCHVISION_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21)


class VGG16Features(nn.Module):
    """The four tap activations of a (N, 3, H, W) batch, in the weights'
    dtype: f32, or f64 for a plain reference after `.double()`."""

    def __init__(self):
        super().__init__()
        convs, pools, c_in = [], [], 3
        for slice_cfg in _VGG_SLICES:
            for out_ch, pool_before in slice_cfg:
                convs.append(nn.Conv2d(c_in, out_ch, 3, padding=1))
                pools.append(pool_before)
                c_in = out_ch
        self.convs = nn.ModuleList(convs)
        self._pools = pools
        self._taps = [sum(len(s) for s in _VGG_SLICES[: i + 1]) - 1 for i in range(len(_VGG_SLICES))]
        self.requires_grad_(False)  # a fixed feature map: nothing trains it

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.to(self.convs[0].weight.dtype)
        taps = []
        with conv_precision():
            for i, (conv, pool) in enumerate(zip(self.convs, self._pools)):
                if pool:
                    x = F.max_pool2d(x, 2, 2)
                x = F.relu(conv(x))
                if i in self._taps:
                    taps.append(x)
        return taps


def load_torch_vgg_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision vgg16 state dict -> `VGG16Features`' state dict: the
    `features.{i}` conv entries up to index 21, in torch's layout."""
    out = {}
    for conv_idx, feat_idx in enumerate(TORCHVISION_CONV_INDICES):
        for leaf in ("weight", "bias"):
            out[f"convs.{conv_idx}.{leaf}"] = torch.as_tensor(state_dict[f"features.{feat_idx}.{leaf}"]).float()
    return out


def init_vgg(model: VGG16Features, generator: torch.Generator) -> VGG16Features:
    """flax's default `Conv` init, drawn from `generator`: LeCun normal (a
    normal of std sqrt(1 / fan_in) / 0.8796 truncated at two of its stds,
    variance 1 / fan_in) kernels, zero biases."""
    with torch.no_grad():
        for conv in model.convs:
            fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            conv.bias.zero_()
    return model


def make_perceptual_fn(vgg: VGG16Features) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """perceptual_fn(pred_vol, target_vol) -> scalar: for each channel, the
    (B, 1, D, H, W) volumes folded to (B * D) slices, repeated to three
    channels, the mean over the four taps of each tap's MSE in f32; then
    the mean over the channels."""

    def one_view(x2d):
        if x2d.shape[1] == 1:
            x2d = x2d.repeat(1, 3, 1, 1)
        return vgg(x2d)

    def fold(v):  # (B, 1, D, H, W) -> (B * D, 1, H, W)
        v = v.transpose(1, 2)
        return v.reshape(-1, *v.shape[2:])

    def per_channel(x1, x2):
        a_taps, b_taps = one_view(fold(x1)), one_view(fold(x2))
        losses = [((a.float() - b.float()) ** 2).mean() for a, b in zip(a_taps, b_taps)]
        return torch.stack(losses).mean()

    def perceptual_fn(pred_vol: torch.Tensor, target_vol: torch.Tensor) -> torch.Tensor:
        ch = pred_vol.shape[1]
        total = 0.0
        for idx in range(ch):
            total = total + per_channel(pred_vol[:, idx: idx + 1], target_vol[:, idx: idx + 1])
        return total / ch

    return perceptual_fn


def build_perceptual(vgg_ckpt: Optional[str] = None, seed: int = 0, device=None):
    """-> (VGG16Features on `device`, perceptual_fn). Loads a torchvision
    VGG16 state dict from `vgg_ckpt` (`torch.load(..., weights_only=True)`),
    else draws seeded random weights with a loud warning. `device` as
    `resolve_device` reads it: the card unless the caller names another."""
    dev = resolve_device(device)
    model = VGG16Features()
    if vgg_ckpt is not None:
        try:
            sd = torch.load(vgg_ckpt, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{vgg_ckpt} holds a pickled module, which torchvision would be needed to unpickle; "
                "save the model's state_dict() instead") from e
        model.load_state_dict(load_torch_vgg_state_dict(sd), strict=True)
    else:
        print("WARNING: no VGG checkpoint given - perceptual loss uses random "
              "(He-init) features, not the reference's pretrained ones")
        init_vgg(model, torch.Generator().manual_seed(seed))
    model = model.to(dev)
    return model, make_perceptual_fn(model)
