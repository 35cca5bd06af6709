"""Checkpoints of the port, and the weight bridge from the JAX package.

The port cannot read or write the JAX package's orbax checkpoints (that
needs JAX). Its pipelines write two kinds of file instead, each through a
temporary file that `os.replace` moves into place, so a killed run leaves
the previous file whole:

- `save_state_dict(path, state_dict)`: the reference-layout state dict
  (CPU tensors under the reference PyTorch keys), as
  `checkpoint-min_loss.pth`;
  `load_reference_state_dict` and `serve --checkpoint` read it;
- `CheckpointManager`: a fold's resume checkpoint, one `torch.save` file
  holding the model (BatchNorm statistics included), the AdamW state and
  its update count, the step, the masking generator's state, the epoch
  and the best loss so far.

The weight bridge reads exactly two inputs:

- `params_from_jax(tree, patch_size, in_chans, batch_stats)`: a JAX param
  tree (MAE or ViT) and, for the contrastive heads, its flax `batch_stats`
  tree, as nested dicts of arrays, e.g. loaded by the JAX package and
  passed on as numpy;
- `load_reference_state_dict(path)`: the `.pth` that the JAX package's
  `export-torch` command writes (`export_mae_torch_state_dict` + `torch.save`),
  or this package's `checkpoint-min_loss.pth`.

Both give a state dict under the reference PyTorch keys, which are the
port's parameter names. The mapping is this package's own copy of the JAX
package's `export_torch_state_dict` (train/checkpoint.py there).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple

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


def _batch_stat_name(path: Tuple[str, ...]) -> str:
    """flax batch_stats leaf (heads, head, BatchNorm_k, mean|var) -> the
    reference key of its BatchNorm1d buffer."""
    if path[0] != "heads" or len(path) != 4 or path[3] not in ("mean", "var"):
        raise ValueError(f"unexpected batch_stats leaf {'/'.join(path)}")
    head, layer, leaf = path[1], path[2], path[3]
    idx = _HEAD_LAYER_TO_SEQ[head][layer]
    return f"{_HEAD_TORCH_NAME[head]}.{idx}.running_{leaf}"


def params_from_jax(
    tree: Dict, patch_size: int, in_chans: int = 1, batch_stats: Optional[Dict] = None
) -> Dict[str, torch.Tensor]:
    """A JAX param tree (MAE or ViT; nested dicts of arrays) and optionally
    its flax `batch_stats` tree -> a state dict under the reference keys
    (BatchNorm statistics as `predictor.1.running_mean` / `running_var`).
    `patch_size` and `in_chans` unfold the (p^3*C, D) patch-embed kernel
    into the Conv3d layout."""
    sd: Dict[str, torch.Tensor] = {}
    for path, w in _flatten(tree):
        name, value = _torch_name_and_value(path, np.asarray(w), patch_size, in_chans)
        sd[name] = torch.from_numpy(np.array(value))
    for path, w in _flatten(batch_stats or {}):
        sd[_batch_stat_name(path)] = torch.from_numpy(np.array(w))
    return sd


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `.pth` (as `export-torch` writes it) to CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "patch_embed.proj.weight" not in sd:
        raise ValueError(f"{path} is not a reference-layout state dict")
    return sd


def _save_atomic(obj, path: str) -> None:
    """`torch.save` into a temporary file beside `path`, synced to disk, then
    moved over `path`: a reader never sees a half-written file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_state_dict(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write a reference-layout state dict as `path`, CPU tensors,
    atomically."""
    _save_atomic({k: v.detach().cpu() for k, v in state_dict.items()}, path)


class CheckpointManager:
    """A fold's resume checkpoint: `directory/checkpoint.pth`, one file that
    each `save` replaces. The JAX package keeps the same payload in orbax
    directories; the port cannot read those."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(self.directory, "checkpoint.pth")

    def save(self, state, epoch: int, min_loss: float = float("inf")) -> None:
        _save_atomic({
            "model": state.model.state_dict(),
            "optimizer": state.tx.opt.state_dict(),
            "count": state.tx.count,
            "step": state.step,
            "generator": state.generator.get_state(),
            "epoch": int(epoch),
            "min_loss": float(min_loss),
        }, self.path)

    def restore(self, state):
        """-> (state, epoch, min_loss); epoch is None when no checkpoint exists
        (epoch 0 is a valid resumable checkpoint). min_loss restores the best
        so far, so a resumed run cannot overwrite the min-loss checkpoint with
        worse weights."""
        if not os.path.exists(self.path):
            return state, None, float("inf")
        payload = torch.load(self.path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        state.tx.opt.load_state_dict(payload["optimizer"])
        state.tx.count = payload["count"]
        state.step = payload["step"]
        state.generator.set_state(payload["generator"])
        return state, payload["epoch"], payload["min_loss"]
