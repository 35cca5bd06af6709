"""The int8 inference engine: the ViT trunk's Dense products on int8 operands.

Counterpart of the JAX package's models/quant.py, over the port's state
dicts (reference keys, `params_from_jax`'s output included):

- weights: symmetric per-output-channel int8 (absmax / 127), quantised once
  at load (`quantize_params`): every block's qkv, proj, fc1 and fc2 and the
  patch embed's (D, p^3 C) matrix;
- activations: symmetric per-token int8, computed on the fly
  (`quantize_tokens`);
- the int8 x int8 -> int32 product (`int8_matmul`), dequantised as
  `acc * xscale * scale`, then `+ bias`, in f32, then cast to the compute
  dtype; LayerNorm, attention, GELU and the residual stream stay in the
  compute dtype as in the trunk.

The int8 product is one the JAX package computes outside any Pallas kernel
(`lax.dot_general`), so here it is `torch._int_mm`: exact on the CPU, and
cuBLASLt's int8 GEMM on the card, which takes more than 16 rows, sizes that
are multiples of 8 and a K-major second operand (the weight is stored
(out, in) and passed transposed). A shape outside that raises; nothing
falls back to a bf16 product. Attention takes the per-head path
(`multihead_attention`): 'auto' is the per-head kernel on the card
(csrc/flash_fwd.cu) and the plain version on the CPU.

With `quantized=False`, `quant_forward_features` over the raw state dict is
the trunk's own `forward_features`, operation for operation (the wiring
check of the JAX package's tests).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vit_ae_plus_plus_torch.configs import ViTConfig
from vit_ae_plus_plus_torch.kernels import multihead_attention
from vit_ae_plus_plus_torch.models.vit import _dense, compute_dtype, patch_embed_matrix
from vit_ae_plus_plus_torch.ops import patchify

# the state-dict weights that run on int8 operands
_QUANTIZED = re.compile(r"(^|\.)(attn\.qkv|attn\.proj|mlp\.fc1|mlp\.fc2)\.weight$")
_PATCH_EMBED = "patch_embed.proj.weight"


def quantize_dense(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 (out, in), (out,) f32 scale), the scale
    absmax / 127 over each output channel's inputs."""
    w = weight.float()
    scale = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return w8, scale


def quantize_params(state_dict: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """A ViT state dict -> the same keys, every Dense weight of the blocks
    and the patch embed's replaced by `{"w8": int8 (out, in), "scale": (out,)
    f32}` on the weight's device; everything else passes through."""
    out: Dict[str, object] = {}
    for key, w in state_dict.items():
        if key == _PATCH_EMBED:
            w = patch_embed_matrix(w)
        if key == _PATCH_EMBED or _QUANTIZED.search(key):
            w8, scale = quantize_dense(w)
            out[key] = {"w8": w8, "scale": scale}
        else:
            out[key] = w
    return out


def quantize_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) -> (int8 (..., K), f32 (..., 1) per-token scale): absmax / 127
    over each token, then round half to even and clip to +-127."""
    xf = x.float()
    xscale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-12) / 127.0
    return torch.clamp(torch.round(xf / xscale), -127, 127).to(torch.int8), xscale


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times the transpose of (N, K) int8 -> (M, N) int32, exact.
    Raises for a shape the card's int8 GEMM does not take (M <= 16, K or N
    not a multiple of 8), on every device alike."""
    (m, k), n = x8.shape, w8.shape[0]
    if m <= 16 or k % 8 or n % 8 or w8.shape[1] != k:
        raise ValueError(f"int8 product of ({m}, {k}) and ({k}, {n}) refused: it needs more than 16 rows "
                         f"and both sizes multiples of 8 (weight {tuple(w8.shape)})")
    return torch._int_mm(x8.contiguous(), w8.t())


def _qdot(x: torch.Tensor, w, bias: Optional[torch.Tensor], quantized: bool, out_dtype: torch.dtype
          ) -> torch.Tensor:
    """x W^T (+ bias). Quantized: per-token int8 x per-channel int8 ->
    int32 -> `acc * xscale * scale + bias` in f32 -> `out_dtype`. Else the
    trunk's own Dense (`_dense`) in x's dtype."""
    if not quantized:
        return _dense(x, w, bias).to(out_dtype)
    x8, xscale = quantize_tokens(x)
    acc = int8_matmul(x8.reshape(-1, x.shape[-1]), w["w8"]).view(*x.shape[:-1], -1)
    y = acc.float() * xscale * w["scale"]
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def _layer_norm(x: torch.Tensor, params: Dict, name: str) -> torch.Tensor:
    """The trunk's LayerNorm (eps 1e-6): at least f32 inside, x's dtype out."""
    dt = torch.promote_types(x.dtype, torch.float32)
    w, b = params[name + ".weight"], params[name + ".bias"]
    return F.layer_norm(x.to(dt), w.shape, w.to(dt), b.to(dt), 1e-6).to(x.dtype)


def _block(x, params: Dict, p: str, num_heads: int, impl: str, quantized: bool, dtype):
    b, n, c = x.shape
    y = _layer_norm(x, params, p + "norm1")
    qkv = _qdot(y, params[p + "attn.qkv.weight"], params[p + "attn.qkv.bias"], quantized, dtype)
    q, k, v = qkv.view(b, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4).unbind(0)
    attn = multihead_attention(q, k, v, impl).transpose(1, 2).reshape(b, n, c)
    x = x + _qdot(attn, params[p + "attn.proj.weight"], params[p + "attn.proj.bias"], quantized, dtype)
    y = _layer_norm(x, params, p + "norm2")
    y = F.gelu(_qdot(y, params[p + "mlp.fc1.weight"], params[p + "mlp.fc1.bias"], quantized, dtype))
    return x + _qdot(y, params[p + "mlp.fc2.weight"], params[p + "mlp.fc2.bias"], quantized, dtype)


def quant_forward_features(params: Dict, cfg: ViTConfig, volume: torch.Tensor, quantized: bool = True
                           ) -> torch.Tensor:
    """`VisionTransformer3D.forward_features` over a state dict -> f32
    features. `params` comes from `quantize_params` when `quantized`, else it
    is the raw state dict. Attention: cfg.attn_impl, 'auto' being the
    per-head kernel on the card and the plain version on the CPU."""
    dtype = compute_dtype(cfg.dtype)
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "flash" if volume.is_cuda else "plain"
    with torch.inference_mode():
        w = params[_PATCH_EMBED]
        x = _qdot(patchify(volume.to(dtype), cfg.patch_size), w if quantized else patch_embed_matrix(w),
                  params["patch_embed.proj.bias"], quantized, dtype)
        cls = params["cls_token"].to(dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(dtype)
        for i in range(cfg.depth):
            x = _block(x, params, f"blocks.{i}.", cfg.num_heads, impl, quantized, dtype)
        if cfg.global_pool:
            return _layer_norm(x[:, 1:].mean(dim=1), params, "fc_norm").float()
        return _layer_norm(x, params, "norm")[:, 0].float()


class QuantizedViT(torch.nn.Module):
    """A ViT's state dict quantised once (`quantize_params`) and run by
    `quant_forward_features`; `forward` adds the classifier head in f32.
    Holds no parameters of its own, so any code that takes the trunk's
    `forward_features` (serving, `loader_features`) takes it."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        self.params = quantize_params(state_dict)

    @classmethod
    def from_quantized(cls, params: Dict[str, object], cfg: ViTConfig) -> "QuantizedViT":
        """A QuantizedViT over `params` that `quantize_params` made earlier (a
        precompiled engine's, serving_aot.py): nothing is quantised again."""
        model = cls.__new__(cls)
        torch.nn.Module.__init__(model)
        model.cfg, model.params = cfg, params
        return model

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        return quant_forward_features(self.params, self.cfg, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.forward_features(x)
        with torch.inference_mode():
            return F.linear(feats, self.params["head.weight"].float(), self.params["head.bias"].float())
