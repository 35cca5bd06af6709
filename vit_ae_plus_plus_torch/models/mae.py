"""3D masked autoencoder in PyTorch.

Counterpart of the JAX package's models/mae.py (`MaskedAutoencoderViT3D`):

- fixed 3D sincos position tables for encoder and decoder, held as buffers
  (not parameters, and not in the state dict);
- random masking by stable argsort of uniform noise (ops/masking.py), the
  noise drawn from the caller's `torch.Generator` or passed in;
- encoder: cls token + kept tokens through `depth` blocks + LayerNorm;
- decoder: Linear embed, mask tokens scattered back by the inverse
  permutation, decoder position table, `decoder_depth` blocks, per-patch
  regression head, cls dropped;
- contrastive variant: both views go through ONE encoder call as a batch of
  2B (the blocks have no batch statistics), then the per-token latents
  (cls included) of each view go through the predictor separately, so its
  BatchNorm statistics move twice per step, once per view; z1 and z2 are
  detached. The optional projector is built but never applied (the
  reference's quirk, kept for its checkpoints).

Parameters carry the reference PyTorch keys (`blocks.N.attn.qkv.weight`,
`decoder_embed.weight`, `mask_token`, `predictor.1.weight`, ...), so the
weight bridge (train/checkpoint.py) loads a JAX param tree with
`strict=True`. Precision: parameters stay f32 and are cast per call to the
compute dtype; LayerNorm and BatchNorm statistics are at least f32, except
in the blocks under `ln_dtype="bfloat16"`. `ln_fusion` and `ln_dtype` reach
the encoder and decoder blocks; `norm` and `decoder_norm` stay unfused.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models.vit import (
    Block,
    MLPHead,
    PatchEmbed3D,
    _layer_norm,
    _linear,
    compute_dtype,
)
from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed, random_masking, restore_tokens


class MaskedAutoencoderViT3D(nn.Module):
    def __init__(self, cfg: MAEConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        d, dd = cfg.embed_dim, cfg.decoder_embed_dim
        grid = round(cfg.num_patches ** (1 / 3))

        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.in_chans, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.register_buffer("pos_embed", self._table(d, grid), persistent=False)
        self.blocks = nn.ModuleList(
            Block(d, cfg.num_heads, cfg.mlp_ratio, cfg.attn_impl, cfg.ln_fusion, cfg.ln_dtype)
            for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(d, eps=1e-6)

        self.decoder_embed = nn.Linear(d, dd)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dd))
        self.register_buffer("decoder_pos_embed", self._table(dd, grid), persistent=False)
        self.decoder_blocks = nn.ModuleList(
            Block(dd, cfg.decoder_num_heads, cfg.mlp_ratio, cfg.attn_impl, cfg.ln_fusion, cfg.ln_dtype)
            for _ in range(cfg.decoder_depth)
        )
        self.decoder_norm = nn.LayerNorm(dd, eps=1e-6)
        self.decoder_pred = nn.Linear(dd, cfg.patch_dim)

        if cfg.contrastive:
            if cfg.use_proj:  # built, never applied
                self.projection_head = MLPHead(d, num_hidden=2, final_dense=False, dtype=self.dtype)
            self.predictor = MLPHead(d, num_hidden=1, final_dense=True, dtype=self.dtype)

    @staticmethod
    def _table(dim: int, grid: int) -> torch.Tensor:
        return torch.from_numpy(get_3d_sincos_pos_embed(dim, grid, cls_token=True)[None]).float()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None) -> "MaskedAutoencoderViT3D":
        """The JAX package's initialisation: xavier-uniform Linear weights
        (the patch embed as its (p^3 C, D) matrix) with zero biases, tokens
        N(0, 0.02), LayerNorm 1/0; the contrastive heads keep PyTorch's
        Linear default (uniform, variance 1/(3 fan_in)) with zero biases."""
        heads = {m for name in ("predictor", "projection_head") if hasattr(self, name)
                 for m in getattr(self, name).modules()}
        for m in self.modules():
            if isinstance(m, nn.Linear):
                fan_out, fan_in = m.weight.shape
                var = 1.0 / (3 * fan_in) if m in heads else 2.0 / (fan_in + fan_out)
                lim = math.sqrt(3 * var)
                m.weight.uniform_(-lim, lim, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        w = self.patch_embed.proj.weight
        lim = math.sqrt(6.0 / (w[0].numel() + w.shape[0]))
        w.uniform_(-lim, lim, generator=generator)
        self.patch_embed.proj.bias.zero_()
        for t in (self.cls_token, self.mask_token):
            t.normal_(0.0, 0.02, generator=generator)
        return self

    def forward_encoder(self, x, mask_ratio: float, noise: Optional[torch.Tensor] = None):
        """(B, C, S, S, S) -> latent (B, 1 + len_keep, D), mask (B, L) in the
        compute dtype (1 = removed), ids_restore (B, L)."""
        x = self.patch_embed(x, self.dtype)
        x = x + self.pos_embed[:, 1:].to(x.dtype)
        b, l, d = x.shape
        if mask_ratio > 0:
            x, mask, ids_restore = random_masking(x, mask_ratio, noise)
        else:
            mask = torch.zeros((b, l), dtype=x.dtype, device=x.device)
            ids_restore = torch.arange(l, device=x.device).expand(b, l)
        cls = self.cls_token.to(x.dtype) + self.pos_embed[:, :1].to(x.dtype)
        x = torch.cat([cls.expand(x.shape[0], -1, -1), x], dim=1)
        for blk in self.blocks:
            x = blk(x)
        return _layer_norm(x, self.norm), mask, ids_restore

    def forward_decoder(self, latent, ids_restore):
        """latent (B, 1 + len_keep, D) -> pred (B, L, p^3 C)."""
        x = _linear(latent, self.decoder_embed)
        x = torch.cat([x[:, :1], restore_tokens(x[:, 1:], self.mask_token, ids_restore)], dim=1)
        x = x + self.decoder_pos_embed.to(x.dtype)
        for blk in self.decoder_blocks:
            x = blk(x)
        return _linear(_layer_norm(x, self.decoder_norm), self.decoder_pred)[:, 1:]

    def forward(
        self,
        view1: torch.Tensor,
        view2: Optional[torch.Tensor] = None,
        mask_ratio: float = 0.75,
        noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """The full forward: a dict of `pred`, `mask`, `ids_restore`,
        `latent` and, contrastive with `view2`, `p1`, `p2`, `z1`, `z2`.

        `noise` (rows, L) is the masking noise, one row per encoded volume
        (2B rows when both views are encoded); without it, uniform noise is
        drawn from `generator`."""
        contrastive = self.cfg.contrastive and view2 is not None
        both = torch.cat([view1, view2], dim=0) if contrastive else view1
        if noise is None and mask_ratio > 0:
            noise = torch.rand((both.shape[0], self.cfg.num_patches), generator=generator,
                               device=both.device)
        latent_all, mask_all, ids_all = self.forward_encoder(both, mask_ratio, noise)
        b = view1.shape[0]
        latent, mask, ids_restore = latent_all[:b], mask_all[:b], ids_all[:b]
        out = {"pred": self.forward_decoder(latent, ids_restore), "mask": mask,
               "ids_restore": ids_restore, "latent": latent}
        if contrastive:
            z1 = latent.reshape(-1, latent.shape[-1])
            z2 = latent_all[b:].reshape(-1, latent.shape[-1])
            out.update(p1=self.predictor(z1), p2=self.predictor(z2),
                       z1=z1.detach(), z2=z2.detach())
        return out
