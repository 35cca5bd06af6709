"""The weight bridge: JAX parameters and reference `.pth` files into the port.

The port cannot read the JAX package's orbax checkpoints (that needs JAX),
so it reads exactly two inputs:

- `params_from_jax(tree, patch_size, in_chans)`: a JAX param tree (MAE or
  ViT) as nested dicts of arrays, e.g. loaded by the JAX package and passed
  on as numpy;
- `load_reference_state_dict(path)`: the `.pth` that the JAX package's
  `export-torch` command writes (`export_mae_torch_state_dict` + `torch.save`).

Both give a state dict under the reference PyTorch keys, which are the
port's parameter names. The mapping is this package's own copy of the JAX
package's `export_torch_state_dict` (train/checkpoint.py there).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# contrastive heads: flax MLPHead layer names -> reference Sequential indices
_HEAD_LAYER_TO_SEQ = {
    "predictor": {"Dense_0": 0, "BatchNorm_0": 1, "Dense_1": 3},
    "projector": {
        "Dense_0": 0, "BatchNorm_0": 1, "Dense_1": 3,
        "BatchNorm_1": 4, "Dense_2": 6, "BatchNorm_2": 7,
    },
}
_HEAD_TORCH_NAME = {"predictor": "predictor", "projector": "projection_head"}


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name_and_value(path: Tuple[str, ...], w: np.ndarray, patch_size: int, in_chans: int):
    """One JAX leaf -> (reference key, value in the reference layout)."""
    if path[0] == "patch_embed":
        if path[-1] == "kernel":
            # rows (dz, dy, dx, c) -> Conv3d (D, C, pz, py, px)
            kernel = w.reshape(patch_size, patch_size, patch_size, in_chans, w.shape[-1])
            return "patch_embed.proj.weight", kernel.transpose(4, 3, 0, 1, 2)
        return "patch_embed.proj.bias", w
    if path[0] in ("cls_token", "mask_token", "pos_embed"):
        return path[0], w
    if path[0] == "heads":
        head, layer, leaf = path[1], path[2], path[3]
        idx = _HEAD_LAYER_TO_SEQ[head][layer]
        torch_leaf = "weight" if leaf in ("kernel", "scale") else "bias"
        return f"{_HEAD_TORCH_NAME[head]}.{idx}.{torch_leaf}", (w.T if leaf == "kernel" else w)
    parts = list(path)
    # blocks_N / decoder_blocks_N -> blocks.N
    if "_" in parts[0] and parts[0].rsplit("_", 1)[0] in ("blocks", "decoder_blocks"):
        stack, num = parts[0].rsplit("_", 1)
        parts = [stack, num] + parts[1:]
    # flax Mlp Dense_0/Dense_1 -> reference mlp.fc1/fc2
    parts = ["fc1" if p == "Dense_0" else "fc2" if p == "Dense_1" else p for p in parts]
    leaf, sub = parts[-1], ".".join(parts[:-1])
    if leaf == "scale":
        return f"{sub}.weight", w
    if leaf == "kernel":
        return f"{sub}.weight", w.T
    if leaf == "bias":
        return f"{sub}.bias", w
    return ".".join(parts), w


def params_from_jax(tree: Dict, patch_size: int, in_chans: int = 1) -> Dict[str, torch.Tensor]:
    """A JAX param tree (MAE or ViT; nested dicts of arrays) -> a state dict
    under the reference keys. `patch_size` and `in_chans` unfold the
    (p^3*C, D) patch-embed kernel into the Conv3d layout."""
    sd: Dict[str, torch.Tensor] = {}
    for path, w in _flatten(tree):
        name, value = _torch_name_and_value(path, np.asarray(w), patch_size, in_chans)
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    return sd


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `.pth` (as `export-torch` writes it) to CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "patch_embed.proj.weight" not in sd:
        raise ValueError(f"{path} is not a reference-layout state dict")
    return sd
