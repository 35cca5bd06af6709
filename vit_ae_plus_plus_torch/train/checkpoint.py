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
  its update count, under gradient accumulation the running mean and the
  mini-step (optax's `MultiStepsState`), the step, the masking generator's
  state, the epoch and the best loss so far.

The weight bridge reads exactly two inputs:

- `params_from_jax(tree, patch_size, in_chans, batch_stats)`: a JAX param
  tree (MAE, ViT, 3D ResNet or MoCo; a MAE's also in the pipeline's
  stacked layout) and its flax `batch_stats` tree (the
  contrastive heads', the ResNet's, the MoCo heads'), as nested dicts of
  arrays, e.g. loaded by the JAX package and passed on as numpy;
- `load_reference_state_dict(path)`: the `.pth` that the JAX package's
  `export-torch` command writes (`export_mae_torch_state_dict` + `torch.save`),
  or this package's `checkpoint-min_loss.pth`.

Both give a state dict under the reference PyTorch keys, which are the
port's parameter names. The ViT mapping is this package's own copy of the
JAX package's `export_torch_state_dict` (train/checkpoint.py there); the
ResNet's follows flax's module order (Conv_k, BatchNorm_k and the blocks
numbered through all four stages) onto the reference's `conv1`, `bn1`,
`layer{s}.{b}.conv{i}` / `bn{i}` / `downsample.{0,1}` and `fc`. A MoCo
tree (top-level `trunk`, `projector`, `predictor`) goes to the reference
MoCo layout: the trunk under `base_encoder.`, the projector where the
reference grafts it (`base_encoder.head.` on a ViT, `base_encoder.fc.` on a
ResNet), the predictor under `predictor.`, each head's `Dense_l` /
`BatchNorm_l` at Sequential index 3l / 3l + 1. A contrastive ViT tree
(top-level `trunk` and `heads`, `VisionTransformer3DContrastive`) goes to
`trunk.*` and `heads.predictor.*` / `heads.projector.*`, each head's
layers where the MAE's heads put them. The perceptual loss's VGG16 tree
(top-level `conv_0` ... `conv_9`, models/vgg.py there) goes to
`VGG16Features`' `convs.{i}`, its (kh, kw, I, O) kernels to (O, I, kh, kw).

`export_torch(path, cfg)` is the `export-torch` command's body: it turns
the port's own MAE files (a resume `checkpoint.pth`, a directory of GPipe
`checkpoint-stage{p}.pth` files, or a reference-layout `.pth`) into one
strict reference-layout state dict, with the keys the JAX package's
`export_mae_torch_state_dict` gives (`reference_mae_state_dict`);
`load_exported_mae` loads such a dict back into the port's MAE.
`resolve_checkpoint_path` turns a checkpoint URL into a cached local file.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from vit_ae_plus_plus_torch.parallel import fsdp

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


def _resnet_layout(tree: Dict) -> Dict[str, str]:
    """flax's top-level ResNet3D module names -> the reference prefixes:
    Conv_0 / BatchNorm_0 / Dense_0 -> conv1 / bn1 / fc, the k-th block ->
    layer{s}.{b} by the depth the tree's block class and count give."""
    from vit_ae_plus_plus_torch.models.resnet3d import DEPTH_CONFIGS

    blocks = [k for k in tree if k.startswith(("BasicBlock3D_", "Bottleneck3D_"))]
    kind = blocks[0].rsplit("_", 1)[0] if blocks else None
    layers = next((ls for cls, ls in DEPTH_CONFIGS.values() if cls.__name__ == kind and sum(ls) == len(blocks)),
                  None)
    if layers is None:
        raise ValueError(f"no ResNet depth has {len(blocks)} blocks of {kind}")
    names = {"Conv_0": "conv1", "BatchNorm_0": "bn1", "Dense_0": "fc"}
    k = 0
    for stage, n in enumerate(layers):
        for b in range(n):
            names[f"{kind}_{k}"] = f"layer{stage + 1}.{b}"
            k += 1
    return names


def _resnet_block_layer(layer: str, n_convs: int) -> str:
    """A block's Conv_i / BatchNorm_i -> conv{i+1} / bn{i+1}, the last one
    (past the block's own n_convs) -> the shortcut's downsample.{0,1}."""
    kind, i = layer.rsplit("_", 1)
    if int(i) == n_convs:
        return "downsample.0" if kind == "Conv" else "downsample.1"
    return f"conv{int(i) + 1}" if kind == "Conv" else f"bn{int(i) + 1}"


def _resnet_state_dict(tree: Dict, batch_stats: Optional[Dict]) -> Dict[str, torch.Tensor]:
    prefixes = _resnet_layout(tree)
    sd: Dict[str, torch.Tensor] = {}
    leaf_names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}
    for source in (tree, batch_stats or {}):
        for path, w in _flatten(source):
            w = np.asarray(w)
            name = prefixes[path[0]]
            if len(path) == 3:  # inside a block
                name += "." + _resnet_block_layer(path[1], 2 if path[0].startswith("Basic") else 3)
            if path[-1] == "kernel":  # conv (kd, kh, kw, cin, cout) / dense (in, out)
                w = w.transpose(4, 3, 0, 1, 2) if w.ndim == 5 else w.T
            sd[f"{name}.{leaf_names[path[-1]]}"] = torch.from_numpy(np.array(w))
    return sd


def _moco_head(tree: Dict, stats: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    """A MoCoMLP's flax leaves (Dense_l kernel, BatchNorm_l scale / bias /
    mean / var) -> `prefix{3l}.weight`, `prefix{3l+1}.{weight,bias,
    running_mean,running_var}`."""
    names = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    sd: Dict[str, torch.Tensor] = {}
    for source in (tree, stats):
        for (layer, leaf), w in _flatten(source):
            kind, i = layer.rsplit("_", 1)
            idx = 3 * int(i) + (0 if kind == "Dense" else 1)
            w = np.asarray(w)
            sd[f"{prefix}{idx}.{names[leaf]}"] = torch.from_numpy(np.array(w.T if leaf == "kernel" else w))
    return sd


def _moco_state_dict(tree: Dict, patch_size: Optional[int], in_chans: int,
                     batch_stats: Optional[Dict]) -> Dict[str, torch.Tensor]:
    stats = batch_stats or {}
    trunk = params_from_jax(tree["trunk"], patch_size, in_chans, stats.get("trunk"))
    projector = "base_encoder.fc." if "Conv_0" in tree["trunk"] else "base_encoder.head."
    sd = {f"base_encoder.{k}": v for k, v in trunk.items()}
    sd.update(_moco_head(tree["projector"], stats.get("projector", {}), projector))
    sd.update(_moco_head(tree["predictor"], stats.get("predictor", {}), "predictor."))
    return sd


def _contrastive_state_dict(tree: Dict, patch_size: Optional[int], in_chans: int,
                            batch_stats: Optional[Dict]) -> Dict[str, torch.Tensor]:
    heads = params_from_jax({"heads": tree["heads"]}, patch_size, in_chans,
                            {"heads": (batch_stats or {}).get("heads", {})})
    sd = {f"trunk.{k}": v for k, v in params_from_jax(tree["trunk"], patch_size, in_chans).items()}
    for k, v in heads.items():
        head, rest = k.split(".", 1)
        sd[f"heads.{'projector' if head == _HEAD_TORCH_NAME['projector'] else head}.{rest}"] = v
    return sd


def _vgg_state_dict(tree: Dict) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(tree)):
        leaf = tree[f"conv_{i}"]
        sd[f"convs.{i}.weight"] = torch.from_numpy(np.array(np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"convs.{i}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
    return sd


def _unstack_pp(tree: Dict) -> Dict:
    """JAX `from_pp_params` (parallel/pp.py there) on nested dicts of
    arrays: each 'enc_stack' / 'dec_stack' subtree of (L, ...) leaves back
    to its per-layer `blocks_{i}` / `decoder_blocks_{i}` subtrees."""
    out = {k: v for k, v in tree.items() if k not in ("enc_stack", "dec_stack")}
    for stack, prefix in (("enc_stack", "blocks_"), ("dec_stack", "decoder_blocks_")):
        if stack in tree:
            depth = len(next(iter(v for _, v in _flatten(tree[stack]))))
            for i in range(depth):
                out[f"{prefix}{i}"] = _map_leaves(tree[stack], lambda a, i=i: np.asarray(a)[i])
    return out


def _map_leaves(tree: Dict, fn) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_jax(
    tree: Dict, patch_size: Optional[int] = None, in_chans: int = 1, batch_stats: Optional[Dict] = None
) -> Dict[str, torch.Tensor]:
    """A JAX param tree (MAE, ViT or ResNet3D; nested dicts of arrays) and
    optionally its flax `batch_stats` tree -> a state dict under the
    reference keys (BatchNorm statistics as `*.running_mean` /
    `running_var`). For a ViT tree, `patch_size` and `in_chans` unfold the
    (p^3*C, D) patch-embed kernel into the Conv3d layout; a ResNet tree
    (top-level `Conv_0`) needs neither: its conv kernels go from (kd, kh,
    kw, cin, cout) to (cout, cin, kd, kh, kw); a MoCo tree (top-level
    `trunk`, `projector`, `predictor`, either trunk) and a contrastive ViT
    tree (top-level `trunk`, `heads`) take their trunk's arguments; a VGG16
    tree (top-level `conv_0`) needs none. A MAE or ViT tree in JAX's
    pipeline layout (`to_pp_params`: 'enc_stack' / 'dec_stack') is
    unstacked to its layers first."""
    if "enc_stack" in tree or "dec_stack" in tree:
        tree = _unstack_pp(tree)
    if "conv_0" in tree:
        return _vgg_state_dict(tree)
    if "trunk" in tree and "projector" in tree:
        return _moco_state_dict(tree, patch_size, in_chans, batch_stats)
    if "trunk" in tree and "heads" in tree:
        return _contrastive_state_dict(tree, patch_size, in_chans, batch_stats)
    if "Conv_0" in tree:
        return _resnet_state_dict(tree, batch_stats)
    if patch_size is None:
        raise ValueError("params_from_jax: a ViT tree needs patch_size")
    sd: Dict[str, torch.Tensor] = {}
    for path, w in _flatten(tree):
        name, value = _torch_name_and_value(path, np.asarray(w), patch_size, in_chans)
        sd[name] = torch.from_numpy(np.array(value))
    for path, w in _flatten(batch_stats or {}):
        sd[_batch_stat_name(path)] = torch.from_numpy(np.array(w))
    return sd


def resolve_checkpoint_path(path_or_url: str, cache_dir: Optional[str] = None) -> str:
    """A local path, or an `http://`, `https://` or `file://` URL, for any
    checkpoint argument -> a local path.

    The reference resumes straight from an http(s) URL through
    torch.hub.load_state_dict_from_url (utils/misc.py:318-323). A URL is
    downloaded once into ~/.cache/vit_ae_plus_plus_torch/checkpoints, one
    entry per URL named `sha256(url)[:12] + "_" + basename` (two URLs that
    share a basename do not collide), through a `.part` file that
    `os.replace` moves into place, so an interrupted transfer is never taken
    for a cached checkpoint; a local path passes through untouched. JAX's
    copy reads through `urlretrieve`'s 8 KiB blocks; this one reads 16 MiB
    at a time."""
    if not path_or_url.startswith(("http://", "https://", "file://")):
        return path_or_url
    import hashlib
    import shutil
    import urllib.parse
    import urllib.request

    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache", "vit_ae_plus_plus_torch", "checkpoints")
    os.makedirs(cache_dir, exist_ok=True)
    name = os.path.basename(urllib.parse.urlparse(path_or_url).path) or "checkpoint"
    digest = hashlib.sha256(path_or_url.encode()).hexdigest()[:12]
    target = os.path.join(cache_dir, f"{digest}_{name}")
    if not os.path.exists(target):
        print(f"Downloading checkpoint {path_or_url} -> {target}")
        tmp = target + ".part"
        with urllib.request.urlopen(path_or_url) as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst, 16 << 20)  # a checkpoint is GBs: large reads
        os.replace(tmp, target)
    return target


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference-layout `.pth` (as `export-torch` writes it) to CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict) or "patch_embed.proj.weight" not in sd:
        raise ValueError(f"{path} is not a reference-layout state dict")
    return sd


def save_atomic(obj, path: str) -> None:
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
    save_atomic({k: v.detach().cpu() for k, v in state_dict.items()}, path)


class CheckpointManager:
    """A fold's resume checkpoint: `directory/checkpoint.pth`, one file that
    each `save` replaces. The JAX package keeps the same payload in orbax
    directories; the port cannot read those.

    The file is layout-independent, as JAX's `_host_params` and orbax's
    global arrays are: a state sharded over a mesh (parallel/fsdp.py,
    parallel/tp.py) is saved whole, every rank taking part in the gathers
    and only a manager made with `write` (the writer rank's) writing, and
    restored by cutting the whole leaves to this rank's blocks; so a run
    written under data parallelism resumes under FSDP, and the other way
    round. A GPipe stage (`stage`, parallel/pp.py) writes and reads its own
    file, `checkpoint-stage{p}.pth`, with its blocks and their moments: the
    training layout, which a run resumes only with the same number of
    stages, as the JAX package's stacked orbax checkpoints."""

    def __init__(self, directory: str, write: bool = True, stage: Optional[int] = None):
        self.write = write
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        name = "checkpoint.pth" if stage is None else f"checkpoint-stage{stage}.pth"
        self.path = os.path.join(self.directory, name)

    def save(self, state, epoch: int, min_loss: float = float("inf")) -> None:
        """Write the state whole; collective on a sharded state, where every
        rank calls it."""
        payload = {
            "model": fsdp.full_state_dict(state.model),
            "optimizer": fsdp.full_optimizer_state(state.tx),
            "count": state.tx.count,
            "step": state.step,
            "generator": state.generator.get_state(),
            "epoch": int(epoch),
            "min_loss": float(min_loss),
        }
        if hasattr(state.tx, "acc"):  # MultiSteps: a run killed mid-accumulation resumes it
            payload["accum"] = {"mini_step": state.tx.mini_step,
                                "acc": [a.detach().cpu() for a in fsdp.full_like_params(state.tx, state.tx.acc)]}
        if self.write:
            save_atomic(payload, self.path)

    def restore(self, state):
        """-> (state, epoch, min_loss); epoch is None when no checkpoint exists
        (epoch 0 is a valid resumable checkpoint). min_loss restores the best
        so far, so a resumed run cannot overwrite the min-loss checkpoint with
        worse weights."""
        if not os.path.exists(self.path):
            return state, None, float("inf")
        payload = torch.load(self.path, map_location="cpu", weights_only=True)
        if hasattr(state.tx, "acc") != ("accum" in payload):
            raise ValueError(f"{self.path} was written with another accum_iter setting than this run's "
                             "(gradient accumulation on in one, off in the other)")
        fsdp.load_full_state_dict(state.model, payload["model"], strict=True)
        state.tx.opt.load_state_dict(fsdp.local_optimizer_state(state.tx, payload["optimizer"]))
        state.tx.count = payload["count"]
        if "accum" in payload:
            state.tx.mini_step = payload["accum"]["mini_step"]
            saved = fsdp.local_like_params(state.tx, payload["accum"]["acc"])
            for a, block in zip(state.tx.acc, saved, strict=True):
                a.copy_(block)
        state.step = payload["step"]
        state.generator.set_state(payload["generator"])
        return state, payload["epoch"], payload["min_loss"]


# the MAE's fixed sincos tables: buffers of the port's model (not in its
# state dict), frozen Parameters of the reference's, so its strict load
# expects them (vit_autoenc.py:30,45)
_FIXED_TABLES = ("pos_embed", "decoder_pos_embed")
# files that mark an orbax checkpoint directory (the JAX package's format)
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt", "_sharding")


def reference_mae_state_dict(model_sd: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A MAE's state dict (the port's `model.state_dict()` layout) as CPU
    tensors with what the reference's strict load also expects, as the JAX
    package's `export_mae_torch_state_dict` adds it: the two sincos tables
    (1, N + 1, D) in f32, and `num_batches_tracked` 0 (int64) beside each
    BatchNorm's running statistics."""
    from vit_ae_plus_plus_torch.ops import get_3d_sincos_pos_embed

    sd = {k: v.detach().cpu() for k, v in model_sd.items()}
    for k in list(sd):
        if k.endswith(".running_mean"):
            sd.setdefault(k[: -len("running_mean")] + "num_batches_tracked", torch.tensor(0, dtype=torch.int64))
    grid = round(cfg.num_patches ** (1 / 3))
    for name, dim in zip(_FIXED_TABLES, (cfg.embed_dim, cfg.decoder_embed_dim)):
        sd.setdefault(name, torch.from_numpy(get_3d_sincos_pos_embed(dim, grid, cls_token=True)[None]
                                             .astype(np.float32)))
    return sd


def load_exported_mae(model, sd: Dict[str, torch.Tensor]) -> None:
    """Load a reference-layout MAE state dict (`export_torch`'s, or the JAX
    package's export) into the port's MAE strictly: every key of the
    model's state dict from `sd`, and `sd`'s others only the fixed tables,
    equal to the model's, and `num_batches_tracked`."""
    own = model.state_dict()
    extra = set(sd) - set(own)
    odd = sorted(k for k in extra if k not in _FIXED_TABLES and not k.endswith(".num_batches_tracked"))
    if odd:
        raise ValueError(f"keys the MAE does not have: {odd}")
    for name in extra & set(_FIXED_TABLES):
        if not torch.equal(sd[name].cpu(), getattr(model, name).cpu()):
            raise ValueError(f"{name} differs from the model's table: another volume, patch or width")
    model.load_state_dict({k: v for k, v in sd.items() if k in own}, strict=True)


def _stage_files(directory: str) -> Dict[int, str]:
    """{stage: path} of a GPipe resume directory's `checkpoint-stage{p}.pth`."""
    out = {}
    for path in glob.glob(os.path.join(directory, "checkpoint-stage*.pth")):
        m = re.fullmatch(r"checkpoint-stage(\d+)\.pth", os.path.basename(path))
        if m:
            out[int(m.group(1))] = path
    return out


def _merge_stages(directory: str, files: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """The whole model of a GPipe run's per-stage resume files: each
    stage's blocks (kept under their global layer index) and, from stage
    0, the leaves every stage holds. Refuses a missing stage, a layer that
    two stages hold, and stages saved at different epochs."""
    layout = os.path.join(directory, "layout.json")
    stages = max(files) + 1
    if os.path.exists(layout):
        with open(layout) as f:
            stages = json.load(f).get("pipe", stages)
    missing = sorted(set(range(stages)) - set(files))
    if missing or len(files) != stages:
        raise ValueError(f"{directory}: the GPipe resume files of {stages} stages lack stage(s) {missing} "
                         f"(found {sorted(files)})")
    merged, owner, epochs = {}, {}, {}
    for p in sorted(files):
        payload = torch.load(files[p], map_location="cpu", weights_only=True)
        epochs[p] = payload["epoch"]
        for k, v in payload["model"].items():
            if k.split(".", 1)[0] in ("blocks", "decoder_blocks"):
                if k in owner:
                    raise ValueError(f"{directory}: {k} is in the files of stages {owner[k]} and {p}: a stage "
                                     "appears twice")
                owner[k] = p
                merged[k] = v
            elif p == 0:
                merged[k] = v
    if len(set(epochs.values())) > 1:
        raise ValueError(f"{directory}: the stages' resume files hold different epochs {epochs} (a run stopped "
                         "between their writes)")
    return merged


def _is_orbax(path: str) -> bool:
    if not os.path.isdir(path):
        return False
    names = set(os.listdir(path))
    subdirs = [os.path.join(path, n) for n in names if os.path.isdir(os.path.join(path, n))]
    return bool(names & set(_ORBAX_MARKERS)) or any(set(os.listdir(d)) & set(_ORBAX_MARKERS) for d in subdirs)


def export_torch(path: str, cfg) -> Dict[str, torch.Tensor]:
    """The `export-torch` command's state dict for the MAE preset `cfg`:
    from a resume `checkpoint.pth` (`CheckpointManager`'s payload, its
    `model`), a directory holding one (or the GPipe stage files, merged),
    or a reference-layout `.pth`. The result has exactly the keys and
    shapes of `reference_mae_state_dict` for the preset, as CPU tensors;
    an orbax directory (the JAX package's) is refused."""
    from vit_ae_plus_plus_torch.models import build_model

    if os.path.isdir(path):
        if _is_orbax(path):
            raise ValueError(f"{path} is an orbax checkpoint of the JAX package, which this package cannot read: "
                             "export it with `python -m vit_ae_plus_plus_tpu.cli export-torch`")
        stages = _stage_files(path)
        if os.path.exists(os.path.join(path, "checkpoint.pth")):
            model_sd = torch.load(os.path.join(path, "checkpoint.pth"), map_location="cpu",
                                  weights_only=True)["model"]
        elif stages:
            model_sd = _merge_stages(path, stages)
        else:
            raise FileNotFoundError(f"{path} holds no checkpoint.pth and no checkpoint-stage*.pth")
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(payload, dict) and "model" in payload and "optimizer" in payload:
            model_sd = payload["model"]
        else:
            model_sd = load_reference_state_dict(path)
    sd = reference_mae_state_dict(model_sd, cfg)
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in build_model(cfg).state_dict().items()}
    want.update({k[: -len("running_mean")] + "num_batches_tracked": () for k in want if k.endswith(".running_mean")})
    want.update({name: (1, cfg.num_patches + 1, dim)
                 for name, dim in zip(_FIXED_TABLES, (cfg.embed_dim, cfg.decoder_embed_dim))})
    if set(sd) != set(want):
        raise ValueError(f"{path} does not hold a MAE of this preset: missing "
                         f"{sorted(set(want) - set(sd))[:5]}, unexpected {sorted(set(sd) - set(want))[:5]}")
    wrong = [k for k in want if tuple(sd[k].shape) != want[k]]
    if wrong:
        raise ValueError(f"{path}: shapes differ from the preset's at {wrong[:5]} (check --patch-size and "
                         "--volume-size)")
    return sd
