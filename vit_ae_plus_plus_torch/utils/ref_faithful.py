"""The reference-faithful step: execute what the reference executes.

The port's copy of the JAX package's utils/ref_faithful.py. The port's own
step (train/step.py) batches both views through one encoder pass, keeps the
loss in patch space and the filters separable. This step instead follows
the reference's per-iteration computation graph (reference
model/vit_autoenc.py:205-285, utils/train_one_epoch.py:40-105), so a
benchmark can set the port against the reference's algorithm on the same
card:

- two SEQUENTIAL encoder passes (view1, then view2), not one pass over 2B
  rows (vit_autoenc.py:272,277);
- the attention of a model built with `attn_impl="plain"`: the (B, H, N, N)
  scores materialised (model/vit.py:117-121), f32, batch 4 (config.ini:28);
  the caller builds the model so;
- pred and target both unpatchified every step, though unpatchify after
  patchify is the identity (vit_autoenc.py:211,221);
- the target blurred by the DENSE 11^3 Gaussian convolution, 1,331 MACs a
  voxel (gaussian_filter.py:16-26), not the separable 33;
- Sobel edge maps by the 1 -> 3-channel 3^3 convolution
  (sobel_filter.py:12-45), not the banded products;
- the edge-map MSE computed TWICE, as the reference's eager code does
  (vit_autoenc.py:224-225). The JAX package needs an optimization_barrier
  to keep XLA from merging the two; torch runs eagerly, so both are
  computed and no barrier is needed;
- the VGG16 perceptual forward under no_grad EVERY step: the reference
  evaluates `perceptual_weight * perceptual_loss(...)` before multiplying
  by the (default 0) weight (vit_autoenc.py:229-230). The weights are
  seeded random ones (models/vgg.py `build_perceptual`) unless the caller
  passes its own `perceptual_fn`: the same FLOPs and layout;
- no sync inside the step: the caller's `float(metrics["loss"])` is the
  per-iteration host sync of the reference's loop (loss.item() at
  train_one_epoch.py:60, torch.cuda.synchronize() at :76).
  `torch.cuda.empty_cache()` (:105) is not repeated.

Not reproduced: the host input pipeline. The step runs on tensors already
on the device, which charges the reference's DataLoader and augmentation at
zero.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from vit_ae_plus_plus_torch.ops import masked_mse_loss, negative_cosine_loss, patchify, unpatchify
from vit_ae_plus_plus_torch.ops.filters import gaussian_blur_3d_dense, sobel_edges_3d_conv
from vit_ae_plus_plus_torch.train.state import TrainState


def make_reference_faithful_step(
    model,
    patch_size: int,
    *,
    mask_ratio: float = 0.75,
    contr_weight: float = 0.001,
    run_vgg: bool = True,
    perceptual_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> Callable:
    """Build `step(state, view1, view2, edge_map_weight) -> (state, metrics)`
    running the reference's per-iteration graph (module docstring).

    `noise` (noise1, noise2), each (B, L), is the masking noise of the two
    encoder passes on every call; without it both are drawn from the
    state's generator, view1's first. With `run_vgg` the perceptual forward
    runs through `perceptual_fn`, by default a VGG16 of seeded random
    weights on the model's device. `metrics` holds device scalars: `loss`,
    `edge_map_loss` (unweighted), `reconstruction_loss`, `perceptual_loss`
    (unweighted, outside the loss) and `contr_loss` (weighted)."""
    if run_vgg and perceptual_fn is None:
        from vit_ae_plus_plus_torch.models.vgg import build_perceptual

        _, perceptual_fn = build_perceptual(None, device=next(model.parameters()).device)

    def forward(m, view1, view2, generator):
        # the reference ContrastiveMAEViT.forward (vit_autoenc.py:270-285)
        n1, n2 = noise if noise is not None else (None, None)
        if n1 is None:
            rows = (view1.shape[0], m.cfg.num_patches)
            n1 = torch.rand(rows, generator=generator, device=view1.device)
            n2 = torch.rand(rows, generator=generator, device=view1.device)
        latent, mask, ids_restore = m.forward_encoder(view1, mask_ratio, n1)
        pred = m.forward_decoder(latent, ids_restore)
        latent2, _, _ = m.forward_encoder(view2, mask_ratio, n2)
        z1 = latent.reshape(-1, latent.shape[-1])
        z2 = latent2.reshape(-1, latent2.shape[-1])
        return pred, mask, m.predictor(z1), m.predictor(z2), z1.detach(), z2.detach()

    def step(state: TrainState, view1, view2, edge_map_weight: Union[torch.Tensor, float]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        m = state.model
        m.train()
        pred, mask, p1, p2, z1, z2 = forward(m, view1, view2, state.generator)
        pred = pred.float()
        target = patchify(view1.float(), patch_size)
        # both unpatchified (vit_autoenc.py:221): the target's round trip is
        # the identity, and the reference pays for it
        pred_vol = unpatchify(pred, patch_size)
        target_vol = unpatchify(target, patch_size)

        blurred = gaussian_blur_3d_dense(target_vol, 2.0)
        pred_edges = sobel_edges_3d_conv(pred_vol)
        target_edges = sobel_edges_3d_conv(blurred)
        raw_edge = torch.mean((pred_edges - target_edges) ** 2)
        # the second, duplicated F.mse_loss (vit_autoenc.py:224-225)
        edge_loss = edge_map_weight * torch.mean((pred_edges - target_edges) ** 2)

        recon = masked_mse_loss(pred, target, mask)
        if perceptual_fn is not None:
            # every step, gradient-free, its result multiplied by the
            # default-0 weight after the forward (vit_autoenc.py:229)
            with torch.no_grad():
                percep = perceptual_fn(pred_vol.detach(), target_vol)
        else:
            percep = torch.zeros((), dtype=torch.float32, device=pred.device)
        contr = contr_weight * negative_cosine_loss(p1, p2, z1, z2)
        total = edge_loss + recon + contr

        for p in state.tx.params:
            p.grad = None
        total.backward()
        for p in state.tx.params:
            if p.grad is None:  # never used (the projector): a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
        state.tx.step()
        state.step += 1
        metrics = {
            "loss": total.detach(),
            "edge_map_loss": raw_edge.detach(),
            "reconstruction_loss": recon.detach(),
            "perceptual_loss": percep,
            "contr_loss": contr.detach(),
        }
        return state, metrics

    return step
