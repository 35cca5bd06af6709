"""Checkpoint surgery: pretrained MAE weights -> plain ViT feature extractor.

Counterpart of the JAX package's pipelines/transfer.py, on state dicts under
the reference keys. The blocks, the patch embed and the cls token are copied
from the MAE; the MAE's fixed sincos table is written into the ViT's learned
`pos_embed`, resized when the MAE's patch grid is not the ViT's
(`interpolate_pos_embed`, as the JAX package's graft does); `fc_norm` (or, without global pooling, the MAE's `norm`) and
the classifier head follow the reference: fc_norm fresh (ones and zeros),
head fresh (normal, std 0.02). The set of fresh modules is asserted as the
reference asserts its missing keys. `build_grafted_vit` builds the ViT
with the grafted weights on a device.
"""

from __future__ import annotations

from typing import Dict

import torch

from vit_ae_plus_plus_torch.configs import MAEConfig, ViTConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed, interpolate_pos_embed


def _module_of(key: str) -> str:
    """Top-level module of a state-dict key: 'blocks.3.attn.qkv.weight' ->
    'blocks.3', 'fc_norm.weight' -> 'fc_norm', 'cls_token' -> 'cls_token'."""
    parts = key.split(".")
    return ".".join(parts[:2]) if parts[0] == "blocks" else parts[0]


def mae_params_to_vit(
    mae_sd: Dict[str, torch.Tensor],
    vit_sd: Dict[str, torch.Tensor],
    mae_cfg: MAEConfig,
    vit_cfg: ViTConfig,
) -> Dict[str, torch.Tensor]:
    """The ViT's full state dict with the MAE encoder grafted in.

    `vit_sd` gives the ViT's keys and shapes (a model built on the `meta`
    device will do). The fresh head is drawn from a generator seeded 0."""
    copy_modules = {"patch_embed", "cls_token"}
    if not vit_cfg.global_pool:
        copy_modules.add("norm")
    out: Dict[str, torch.Tensor] = {}
    copied = set()
    for key, w in mae_sd.items():
        mod = _module_of(key)
        if mod in copy_modules or mod.startswith("blocks."):
            out[key] = w
            copied.add(mod)

    table = get_3d_sincos_pos_embed(mae_cfg.embed_dim, mae_cfg.grid_size, cls_token=True)
    out["pos_embed"] = interpolate_pos_embed(torch.as_tensor(table[None], dtype=torch.float32),
                                             vit_cfg.num_patches)

    # the reference's strict-missing-keys assert, as a structural check
    expected_fresh = {"head", "fc_norm"} if vit_cfg.global_pool else {"head"}
    fresh = {_module_of(k) for k in vit_sd} - copied - {"pos_embed"}
    if fresh != expected_fresh:
        raise AssertionError(f"unexpected fresh keys {fresh} (want {expected_fresh})")

    generator = torch.Generator().manual_seed(0)
    for key, ref in vit_sd.items():
        if _module_of(key) not in fresh:
            continue
        if key == "head.weight":
            out[key] = torch.randn(ref.shape, generator=generator) * 0.02
        elif key.endswith(".weight"):  # fc_norm scale
            out[key] = torch.ones(ref.shape)
        else:
            out[key] = torch.zeros(ref.shape)
    return out


def build_grafted_vit(
    mae_sd: Dict[str, torch.Tensor], mae_cfg: MAEConfig, vit_cfg: ViTConfig, device: torch.device
) -> torch.nn.Module:
    """The ViT of `vit_cfg` on `device` holding `mae_params_to_vit`'s
    weights; it is built on the `meta` device, so no weight is initialised
    only to be replaced."""
    with torch.device("meta"):
        model = build_model(vit_cfg)
    sd = mae_params_to_vit(mae_sd, model.state_dict(), mae_cfg, vit_cfg)
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return model
