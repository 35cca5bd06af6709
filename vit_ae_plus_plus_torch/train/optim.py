"""Optimizers and learning-rate schedule of pretraining and fine-tuning.

Counterpart of the JAX package's train/optim.py (`warmup_cosine_schedule`,
`weight_decay_mask`, `make_adamw`, `finetune_weight_decay_mask`,
`layerwise_lr_decay_mask`, `make_layerwise_adamw`, `make_sgd`, and the
frozen backbone of its pipelines/finetune.py), with optax's semantics:

- AdamW(0.9, 0.95), eps 1e-8, as `torch.optim.AdamW` over two parameter
  groups: decay for every parameter with ndim > 1 (cls_token and
  mask_token included), none for biases and norm scales;
- update k (counted from 0, as optax counts) uses the learning rate
  `schedule(k)`;
- `clip_grad`: optax's `clip_by_global_norm`, applied before the update;
- `accum_iter` k > 1: optax's `MultiSteps(chain, every_k_schedule=k)`
  with its default `use_grad_mean` (`MultiSteps` below): a running mean
  of k mini-steps' gradients, the clip and AdamW on the mean at the k-th,
  the parameters and the update count untouched on the other k - 1;
- the fine-tune AdamW(0.9, 0.999) with BEiT layer-wise decay: optax's
  update -lr * s * (adam + wd * p) for a decayed parameter of scale s, and
  -lr * s * adam for an exempt one, is `torch.optim.AdamW`'s decoupled
  decay over one group per (scale, decay) with the group's learning rate
  lr * s;
- SGD with momentum: optax's `trace` is torch SGD's buffer with
  dampening 0; a frozen backbone trains only the classifier head, and the
  optimizer's update count advances with the head's updates;
- Adam with torch's defaults (0.9, 0.999, eps 1e-8, no weight decay) for
  the supervised ResNet, optax's `adam` under a schedule;
- LARS for the MoCo baseline, the JAX package's optax chain and not a
  stock LARS: decay and trust ratio on the ndim > 1 parameters, a trace of
  the raw updates, then the learning rate of the update's count over the
  whole trace (`make_lars`).

On a sharded model (parallel/fsdp.py, parallel/tp.py: the model's
`placements`) each rank's optimizer holds the blocks of its parameters
and updates them elementwise; its moments, traces and running mean are
created from the blocks. Where a rule needs a norm it takes the whole
leaf's or the whole model's: the sum of squares of a sharded leaf's
blocks summed over the axes it is sharded on (`leaf_norms`), the global
norm those sums plus the replicated leaves' once each (`global_norm`). A
GPipe stage's blocks (parallel/pp.py) are placed on 'pipe': each is whole
on its stage, and the global norm adds their sums of squares over the
stages.
`rebuild(model)` makes the same optimizer over a model's new parameters,
as the JAX package's sharding functions re-run `tx.init`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vit_ae_plus_plus_torch.parallel.mesh import get_mesh, sum_over

Schedule = Callable[[int], float]
Axes = Sequence[Tuple[str, ...]]


def warmup_cosine_schedule(
    base_lr: float, min_lr: float, warmup_epochs: float, total_epochs: float, steps_per_epoch: int
) -> Schedule:
    """Per-step learning rate: linear warmup over fractional epochs, then a
    half cosine down to `min_lr` (epoch = step / steps_per_epoch)."""

    def schedule(count: int) -> float:
        epoch = count / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(warmup_epochs, 1e-8)
        denom = max(total_epochs - warmup_epochs, 1e-8)
        return min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (epoch - warmup_epochs) / denom)
        )

    return schedule


def weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True (decay) for weight matrices and tokens (ndim > 1); biases and
    norm scales are exempt."""
    return {name: p.ndim > 1 for name, p in named_params}


def decay_everything(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True for every parameter, biases and norms included: optax's `adamw`
    without a mask (the JAX package's contrastive trainer)."""
    return {name: True for name, _ in named_params}


def global_norm(tensors: Iterable[torch.Tensor], axes: Optional[Axes] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax `global_norm`),
    accumulated in at least f32, without a host sync. `axes[i]`: the mesh
    axes tensor i is a block over (() replicated), whose ranks' sums of
    squares are summed (parallel.mesh `sum_over`); None: all whole."""
    sq = torch.stack([t.to(torch.promote_types(t.dtype, torch.float32)).pow(2).sum() for t in tensors])
    if axes is None or not any(axes):
        return sq.sum().sqrt()
    return sum_over(sq, axes, get_mesh()).sum().sqrt()


def leaf_norms(tensors, axes: Optional[Axes] = None) -> torch.Tensor:
    """Each tensor's norm (`torch._foreach_norm`); a sharded leaf's (axes[i]
    not empty) over its whole: its blocks' sums of squares summed over its
    axes (parallel.mesh `sum_over`)."""
    norms = torch.stack(torch._foreach_norm(tensors))
    if axes is None or not any(axes):
        return norms
    whole = sum_over(torch.stack([t.pow(2).sum() for t in tensors]), axes, get_mesh()).sqrt()
    sharded = torch.tensor([bool(a) for a in axes], device=norms.device)
    return torch.where(sharded, whole.to(norms.dtype), norms)


def _shard_axes(model: nn.Module, names) -> list:
    """The mesh axes each named parameter of `model` is a block over."""
    placements = getattr(model, "placements", {})
    return [tuple(sorted(placements.get(n, {}))) for n in names]


class AdamW:
    """optax's masked AdamW chain over a module's parameters: global-norm
    clipping (optional), then `torch.optim.AdamW` with the learning rate of
    the update's count. `step()` reads the parameters' `.grad`.

    `decay_mask` picks the decayed parameters by name; `lr_scales` (name ->
    scale, default 1) multiplies a parameter's learning rate, as the JAX
    package's `scale_by_trees` multiplies its updates."""

    def __init__(
        self,
        model: nn.Module,
        learning_rate: Union[Schedule, float],
        weight_decay: float = 0.05,
        b1: float = 0.9,
        b2: float = 0.95,
        clip_grad: Optional[float] = None,
        decay_mask: Callable = weight_decay_mask,
        lr_scales: Optional[Dict[str, float]] = None,
    ):
        self._config = dict(learning_rate=learning_rate, weight_decay=weight_decay, b1=b1, b2=b2,
                            clip_grad=clip_grad, decay_mask=decay_mask, lr_scales=lr_scales)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        decay = decay_mask(named)
        scales = lr_scales or {}
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.placements = getattr(model, "placements", {})
        self.shard_axes = _shard_axes(model, self.names)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _k: learning_rate)
        self.clip_grad = clip_grad
        self.count = 0
        groups: Dict[Tuple[float, bool], list] = {}
        for want in (True, False):  # the decayed groups first
            for n, p in named:
                if decay[n] == want:
                    groups.setdefault((scales.get(n, 1.0), want), []).append(p)
        self.opt = torch.optim.AdamW(
            [{"params": ps, "weight_decay": weight_decay if d else 0.0, "lr_scale": s}
             for (s, d), ps in groups.items()],
            lr=self.schedule(0), betas=(b1, b2), eps=1e-8,
        )

    def rebuild(self, model: nn.Module) -> "AdamW":
        """The same optimizer over `model`'s parameters as they are now (its
        state fresh, its count at 0)."""
        return type(self)(model, **self._config)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_grad is not None:
            norm = global_norm(grads, self.shard_axes)
            keep = norm < self.clip_grad
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * self.clip_grad))
        _set_lr(self.opt, self.schedule(self.count))
        self.opt.step()
        self.count += 1


class MultiSteps(AdamW):
    """optax's `MultiSteps(make_adamw chain, every_k_schedule=k)` with
    `use_grad_mean` (the JAX package's `make_adamw(accum_iter=k)`).

    Each `step()` folds the parameters' `.grad` into `acc` as optax's
    running mean, acc + (g - acc) / (n + 1) for the n-th mini-step of the
    cycle (rounded as optax rounds it, not a sum divided by k). At the k-th
    mini-step the mean replaces `.grad`, the inner chain (the clip, then
    AdamW at the learning rate of the update's count) runs on it, `acc`
    returns to zeros and `mini_step` to 0; on the other k - 1 the
    parameters, the AdamW state and `count` stay as they are. `mini_step`
    and `acc` carry over epoch boundaries, and the resume checkpoint holds
    them (train/checkpoint.py)."""

    def __init__(self, model: nn.Module, learning_rate: Union[Schedule, float], accum_iter: int, **kwargs):
        super().__init__(model, learning_rate, **kwargs)
        self._config["accum_iter"] = accum_iter
        self.accum_iter = accum_iter
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def _acc_update(self, grads) -> None:
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, self.mini_step + 1)
        torch._foreach_add_(self.acc, delta)

    def step(self) -> None:
        self._acc_update([p.grad for p in self.params])
        if self.mini_step < self.accum_iter - 1:
            self.mini_step += 1
            return
        with torch.no_grad():
            for p, a in zip(self.params, self.acc):
                p.grad.copy_(a)
                a.zero_()
        super().step()
        self.mini_step = 0


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr * group.get("lr_scale", 1.0)


def make_adamw(
    learning_rate: Union[Schedule, float],
    weight_decay: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.95,
    clip_grad: Optional[float] = None,
    accum_iter: int = 1,
) -> Callable[[nn.Module], AdamW]:
    """The optimizer's recipe, as the JAX package's `make_adamw` returns an
    optax transformation: call it on the model (`create_train_state` does)
    to get the `AdamW` over its parameters, or with `accum_iter` > 1 the
    `MultiSteps` that accumulates that many mini-steps an update."""

    def init(model: nn.Module) -> AdamW:
        kwargs = dict(weight_decay=weight_decay, b1=b1, b2=b2, clip_grad=clip_grad)
        if accum_iter > 1:
            return MultiSteps(model, learning_rate, accum_iter, **kwargs)
        return AdamW(model, learning_rate, **kwargs)

    return init


def finetune_weight_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """The fine-tune decay mask: ndim > 1 and not in the model's
    no_weight_decay set (reference lr_decay.py:32, vit.py:251). The
    patch-embed weight decays in both packages: a 5-D Conv3d weight here, a
    2-D Dense kernel in the JAX package."""
    exempt = {"pos_embed", "cls_token", "dist_token", "mask_token"}
    return {n: p.ndim > 1 and n.split(".")[0] not in exempt for n, p in named_params}


def vit_layer_id(name: str, num_layers: int) -> int:
    """Layer id of a ViT parameter (reference lr_decay.py:64-75): 0 for the
    tokens and the patch embed, i + 1 for block i, num_layers for the rest
    (fc_norm, head)."""
    top = name.split(".")[0]
    if top in ("cls_token", "pos_embed") or top.startswith("patch_embed"):
        return 0
    if top == "blocks":
        return int(name.split(".")[1]) + 1
    return num_layers


def layerwise_lr_decay_mask(
    named_params: Iterable[Tuple[str, torch.Tensor]], depth: int, layer_decay: float = 0.75
) -> Dict[str, float]:
    """Per-parameter learning-rate scale layer_decay ** (num_layers -
    layer_id), num_layers = depth + 1 (reference lr_decay.py:23-25)."""
    num_layers = depth + 1
    return {n: layer_decay ** (num_layers - vit_layer_id(n, num_layers)) for n, _ in named_params}


def make_layerwise_adamw(
    depth: int,
    learning_rate: Union[Schedule, float],
    weight_decay: float = 0.05,
    layer_decay: float = 0.75,
) -> Callable[[nn.Module], AdamW]:
    """AdamW(0.9, 0.999) with BEiT layer-wise learning-rate decay and the
    fine-tune decay mask, no clipping (post_training_utils/
    fine_tune_epoch.py:358-363): a recipe to call on the classifier ViT."""

    def init(model: nn.Module) -> AdamW:
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        return AdamW(model, learning_rate, weight_decay, b1=0.9, b2=0.999,
                     decay_mask=finetune_weight_decay_mask,
                     lr_scales=layerwise_lr_decay_mask(named, depth, layer_decay))

    return init


class SGD:
    """optax's `sgd(schedule, momentum)` over a module's trainable
    parameters: torch SGD with dampening 0 at the learning rate of the
    update's count."""

    def __init__(self, model: nn.Module, learning_rate: Union[Schedule, float], momentum: float = 0.9):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.schedule = learning_rate if callable(learning_rate) else (lambda _k: learning_rate)
        self.count = 0
        self.opt = torch.optim.SGD(self.params, lr=self.schedule(0), momentum=momentum, dampening=0.0)

    def step(self) -> None:
        _set_lr(self.opt, self.schedule(self.count))
        self.opt.step()
        self.count += 1


class Adam(SGD):
    """optax's `adam(schedule)`: torch Adam (0.9, 0.999, eps 1e-8) over a
    module's trainable parameters at the learning rate of the update's
    count."""

    def __init__(self, model: nn.Module, learning_rate: Union[Schedule, float]):
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.schedule = learning_rate if callable(learning_rate) else (lambda _k: learning_rate)
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8)


def make_adam(learning_rate: Union[Schedule, float]) -> Callable[[nn.Module], Adam]:
    """Adam for the supervised 3D ResNet (train_3d_resnet.py:262): a
    recipe."""

    def init(model: nn.Module) -> Adam:
        return Adam(model, learning_rate)

    return init


def make_sgd(learning_rate: Union[Schedule, float], momentum: float = 0.9) -> Callable[[nn.Module], SGD]:
    """SGD with momentum for the linear probe
    (k_fold_cross_valid_linear_projection.py:270-272): a recipe."""

    def init(model: nn.Module) -> SGD:
        return SGD(model, learning_rate, momentum)

    return init


def freeze_backbone_tx(inner: Callable[[nn.Module], object]) -> Callable[[nn.Module], object]:
    """Train only `head.weight` and `head.bias` (linear_projection.py:235-240,
    267-268): the recipe turns `requires_grad` off on every other parameter,
    so the trunk's forward builds no autograd graph and its backward never
    runs (the JAX package's `set_to_zero` updates, whose backward XLA drops),
    then builds `inner` over the two."""

    def init(model: nn.Module):
        for name, p in model.named_parameters():
            p.requires_grad_(name.split(".")[0] == "head")
        n_train = sum(p.requires_grad for p in model.parameters())
        assert n_train == 2, f"expected exactly 2 trainable tensors, got {n_train}"
        return inner(model)

    return init


class _LarsChain(torch.optim.Optimizer):
    """The JAX package's LARS chain as one torch optimizer, in optax's order:
    for a group with `decay`, u = g + wd * p, then u * (tc * |p| / |u|), the
    ratio 1 where either norm is 0 (the norms over the whole tensor);
    u = g otherwise; then trace = u + momentum * trace, p = p + (-lr) *
    trace. Each product is rounded on its own, as optax rounds it."""

    def __init__(self, groups, lr: float, weight_decay: float, momentum: float, trust_coefficient: float,
                 axes_of: Optional[Dict[int, Tuple[str, ...]]] = None):
        super().__init__(groups, dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                                      trust_coefficient=trust_coefficient, decay=False))
        # id(parameter) -> the mesh axes it is a block over: its norms are
        # the whole leaf's (kept off the param groups, which a resume loads)
        self.axes_of = axes_of or {}

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if group["decay"]:
                u = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"]))
                axes = [self.axes_of.get(id(p), ()) for p in params]
                p_norm = leaf_norms(params, axes)
                u_norm = leaf_norms(u, axes)
                ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                    group["trust_coefficient"] * p_norm / u_norm)
                torch._foreach_mul_(u, list(ratio.unbind(0)))
            else:
                u = grads
            traces = []
            for p in params:
                if "trace" not in self.state[p]:
                    self.state[p]["trace"] = torch.zeros_like(p)
                traces.append(self.state[p]["trace"])
            torch._foreach_mul_(traces, group["momentum"])
            torch._foreach_add_(traces, u)
            torch._foreach_add_(params, torch._foreach_mul(traces, -group["lr"]))


class LARS(SGD):
    """The JAX package's `make_lars` chain over a module's trainable
    parameters (`_LarsChain`), at the learning rate of the update's count:
    decay and trust ratio on the parameters `weight_decay_mask` picks
    (ndim > 1: weight matrices, the patch embed's Conv3d weight, cls_token
    and pos_embed), the trace over all of them."""

    def __init__(self, model: nn.Module, learning_rate: Union[Schedule, float], weight_decay: float = 1e-6,
                 momentum: float = 0.9, trust_coefficient: float = 0.001):
        self._config = dict(learning_rate=learning_rate, weight_decay=weight_decay, momentum=momentum,
                            trust_coefficient=trust_coefficient)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        decay = weight_decay_mask(named)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.placements = getattr(model, "placements", {})
        self.shard_axes = _shard_axes(model, self.names)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _k: learning_rate)
        self.count = 0
        self.opt = _LarsChain(
            [{"params": [p for n, p in named if decay[n] == want], "decay": want} for want in (True, False)],
            lr=self.schedule(0), weight_decay=weight_decay, momentum=momentum, trust_coefficient=trust_coefficient,
            axes_of={id(p): a for p, a in zip(self.params, self.shard_axes) if a},
        )

    def rebuild(self, model: nn.Module) -> "LARS":
        """The same LARS over `model`'s parameters as they are now."""
        return LARS(model, **self._config)


def make_lars(learning_rate: Union[Schedule, float], weight_decay: float = 1e-6, momentum: float = 0.9,
              trust_coefficient: float = 0.001) -> Callable[[nn.Module], LARS]:
    """LARS for the MoCo baseline (moco/optimizer.py:10-43, the JAX
    package's `make_lars`): a recipe. Under a per-step schedule the trace of
    raw updates, rescaled by each step's learning rate, is what separates
    it from optax's `lars`, whose trace accumulates lr-scaled steps."""

    def init(model: nn.Module) -> LARS:
        return LARS(model, learning_rate, weight_decay, momentum, trust_coefficient)

    return init
