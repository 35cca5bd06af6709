"""The port's supervised pieces against the JAX package's, on the CPU, at the
tiny preset's classifier ViT (16^3, patch 4, width 24, depth 2, 2 classes):

- `weighted_ce` and `soft_cross_entropy_with_weights` on the same logits,
  f32 and bf16, with and without class weights: 1e-6 of the loss;
- `timm_mixup` and `mixup_3d` with JAX's own lambdas and permutation
  injected: 1e-6 absolute (values of order 1);
- the layer-wise learning-rate scales and the fine-tune decay mask of every
  parameter, equal to the JAX trees carried through `params_from_jax`;
- three steps of `make_supervised_steps` from the same weights (the head
  drawn larger than 2e-5, so that the trunk's gradients matter) and
  batches, with layer-wise AdamW and with the frozen backbone's SGD: each
  step's loss within 1e-5 relative, every parameter after three steps within
  1e-5 of its largest magnitude (the key bias excepted under AdamW: its
  gradient is zero but for rounding, which Adam normalises to full steps;
  measured 1e-6 elsewhere); with the frozen backbone the trunk is
  bitwise unchanged and only the head's two tensors are trained;
- `make_eval_step` (the MAE's reconstruction loss terms) against JAX's step
  body with the masking noise injected: 1e-5 relative;
- `head_init_2e5`: truncated at two standard deviations, bias zero,
  repeatable from its generator.

Random streams differ between the packages (jax.random against torch and
numpy generators), so the draws are injected: ROADMAP Queue 3's stated
divergences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import MAEConfig as JMAEConfig
from vit_ae_plus_plus_tpu.models import MaskedAutoencoderViT3D as JMAE
from vit_ae_plus_plus_tpu.models import build_model as jbuild_model
from vit_ae_plus_plus_tpu.ops import soft_cross_entropy_with_weights as j_soft_ce
from vit_ae_plus_plus_tpu.pipelines import finetune as jft
from vit_ae_plus_plus_tpu.train import TrainState as JTrainState
from vit_ae_plus_plus_tpu.train import optim as joptim
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as j_mae_loss_terms
from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.ops import soft_cross_entropy_with_weights, weighted_ce
from vit_ae_plus_plus_torch.pipelines import finetune as tft
from vit_ae_plus_plus_torch.train import create_train_state
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.train.optim import (
    finetune_weight_decay_mask,
    freeze_backbone_tx,
    layerwise_lr_decay_mask,
    make_layerwise_adamw,
    make_sgd,
)
from vit_ae_plus_plus_torch.train.step import make_eval_step

VOL, PATCH, B, CLASSES = 16, 4, 4, 2
TINY = dict(volume_size=VOL, patch_size=PATCH, embed_dim=24, depth=2, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2)
LOSS_TOL, MIX_TOL, STEP_RTOL, PARAM_TOL = 1e-6, 1e-6, 1e-5, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vit_cfgs():
    return (JMAEConfig(**TINY).encoder_vit_config(num_classes=CLASSES),
            MAEConfig(**TINY).encoder_vit_config(num_classes=CLASSES))


@pytest.fixture(scope="module")
def vit():
    """JAX classifier ViT params (jitted init, leaves randomised; the head
    at 0.3, so its product with the trunk's features is not negligible)."""
    jcfg, tcfg = _vit_cfgs()
    jmodel = jbuild_model(jcfg)
    sample = jnp.zeros((1, 1, VOL, VOL, VOL), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, sample)["params"])
    rng = np.random.default_rng(3)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return ((0.3 if "head" in key else 0.05) * rng.standard_normal(x.shape)).astype(np.float32)

    return jmodel, tcfg, jax.tree_util.tree_map_with_path(leaf, params)


def _port_model(tcfg, params):
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(params, PATCH, 1), strict=True)
    return model


def _data(steps=3, seed=11):
    rng = np.random.default_rng(seed)
    vols = rng.standard_normal((steps, B, 1, VOL, VOL, VOL)).astype(np.float32)
    labels = np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]])[:steps]
    return vols, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(dtype, weighted):
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((8, CLASSES))).astype(np.float32)
    labels = rng.integers(0, CLASSES, 8)
    soft = rng.random((8, CLASSES)).astype(np.float32)
    w = np.array([0.3, 1.7], np.float32) if weighted else None
    jl = jnp.asarray(logits, dtype=getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    cw = w if weighted else np.ones(CLASSES, np.float32)
    want = float(jft.weighted_ce(jl, jnp.asarray(labels), jnp.asarray(cw)))
    got = float(weighted_ce(tl, torch.from_numpy(labels), torch.from_numpy(cw)))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)
    want = float(j_soft_ce(jl, jnp.asarray(soft), None if w is None else jnp.asarray(w)))
    got = float(soft_cross_entropy_with_weights(tl, torch.from_numpy(soft), None if w is None else torch.from_numpy(w)))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


@pytest.mark.parametrize("shards", [2, 4])
def test_weighted_ce_shards_over_the_global_weight_sum_add_up_to_jaxs(shards):
    """A data-parallel step's `weighted_ce` of each shard of the rows over
    the global batch's sum of weights (`weight_sum`): the shards' losses add
    up to JAX's weighted CE of the whole batch."""
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((8, CLASSES))).astype(np.float32)
    labels = np.array([0, 0, 0, 1, 1, 0, 1, 1])
    cw = np.array([0.25, 1.75], np.float32)
    want = float(jft.weighted_ce(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw)))
    total = torch.from_numpy(cw[labels]).sum()
    got = sum(float(weighted_ce(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cw), total))
              for x, y in zip(np.split(logits, shards), np.split(labels, shards)))
    assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


def test_mixups_match_jax_with_injected_draws():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)
    labels = np.array([0, 1, 1, 0])
    key = jax.random.PRNGKey(4)
    for alpha in (0.1, 0.4):
        # timm: one lambda, drawn by JAX as timm_mixup draws it
        want_x, want_y = jft.timm_mixup(key, jnp.asarray(x), jnp.asarray(labels), CLASSES, alpha)
        lam = float(jax.random.beta(key, alpha, alpha))
        got_x, got_y = tft.timm_mixup(torch.from_numpy(x), torch.from_numpy(labels), CLASSES, lam)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=MIX_TOL)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=MIX_TOL)
        # MixUp3D: the permutation and the two lambdas, as mixup_3d draws them
        one_hot = np.eye(CLASSES, dtype=np.float32)[labels]
        want_x, want_y = jft.mixup_3d(key, jnp.asarray(x), jnp.asarray(one_hot), alpha)
        k_perm, k_lx, k_ly = jax.random.split(key, 3)
        perm = np.asarray(jax.random.permutation(k_perm, B))
        lx, ly = float(jax.random.beta(k_lx, alpha, alpha)), float(jax.random.beta(k_ly, alpha, alpha))
        got_x, got_y = tft.mixup_3d(torch.from_numpy(x), torch.from_numpy(one_hot), perm, lx, ly)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=MIX_TOL)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=MIX_TOL)
    draws = tft.mixup_3d_draws(np.random.default_rng([7, 3]), B, 0.1)
    assert sorted(draws[0].tolist()) == list(range(B)) and all(0 <= v <= 1 for v in draws[1:])


def test_layerwise_scales_and_decay_mask_match_jax(vit):
    _, tcfg, params = vit
    model = _port_model(tcfg, params)
    named = list(model.named_parameters())
    for ld in (0.75, 0.5):
        jscale = joptim.layerwise_lr_decay_mask(params, tcfg.depth, ld)
        filled = jax.tree.map(lambda p, s: np.full(p.shape, s, np.float64), params, jscale)
        want = {n: float(np.unique(t.numpy())[0]) for n, t in params_from_jax(filled, PATCH, 1).items()}
        assert layerwise_lr_decay_mask(named, tcfg.depth, ld) == want
    jmask = joptim.finetune_weight_decay_mask(params)
    filled = jax.tree.map(lambda p, m: np.full(p.shape, float(m)), params, jmask)
    want = {n: bool(np.unique(t.numpy())[0]) for n, t in params_from_jax(filled, PATCH, 1).items()}
    assert finetune_weight_decay_mask(named) == want
    assert want["patch_embed.proj.weight"] and not want["pos_embed"] and not want["cls_token"]


def _jax_steps(jmodel, params, mode, vols, labels, sched):
    if mode == "adamw":
        tx = joptim.make_layerwise_adamw(params, TINY["depth"], sched, weight_decay=0.05, layer_decay=0.75)
    else:
        tx = jft.freeze_backbone_tx(params, joptim.make_sgd(sched, momentum=0.9))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                        opt_state=tx.init(params), tx=tx)
    train_step, _ = jft.make_supervised_steps(jmodel, num_classes=CLASSES)
    losses = []
    for v, lab in zip(vols, labels):
        state, m = train_step(state, jnp.asarray(v), jnp.asarray(lab), jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("mode", ["adamw", "frozen_sgd"])
def test_supervised_steps_match_jax(vit, mode):
    jmodel, tcfg, params = vit
    vols, labels = _data()
    base = 5e-3 if mode == "adamw" else 0.5
    jsched = optax.linear_schedule(base, base / 4, 3)
    want_losses, want_params = _jax_steps(jmodel, params, mode, vols, labels, jsched)

    model = _port_model(tcfg, params)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    sched = lambda k: base + (base / 4 - base) * min(k, 3) / 3  # noqa: E731
    tx = make_layerwise_adamw(tcfg.depth, sched, 0.05, 0.75) if mode == "adamw" else \
        freeze_backbone_tx(make_sgd(sched, momentum=0.9))
    state = create_train_state(model, tx)
    train_step, _ = tft.make_supervised_steps(model, num_classes=CLASSES)
    for i, (v, lab) in enumerate(zip(vols, labels)):
        state, m = train_step(state, torch.from_numpy(v), lab, 0)
        got = float(m["loss"])
        assert abs(got - want_losses[i]) <= STEP_RTOL * abs(want_losses[i]), (i, got, want_losses[i])
    assert state.step == state.tx.count == 3
    want_sd = params_from_jax(want_params, PATCH, 1)
    c = tcfg.embed_dim
    for n, p in model.named_parameters():
        got, w = p.detach(), want_sd[n]
        if n.endswith("attn.qkv.bias") and mode == "adamw":
            # the key bias shifts every score of a row alike, so softmax
            # cancels it and its gradient is rounding noise in both
            # packages, which Adam's m / sqrt(v) scales up to steps of the
            # learning rate: held to the three steps' reach, q and v to
            # PARAM_TOL
            assert float((got[c:2 * c] - w[c:2 * c]).abs().max()) <= 2 * 3 * base, n
            got, w = torch.cat([got[:c], got[2 * c:]]), torch.cat([w[:c], w[2 * c:]])
        err = float((got - w).abs().max() / w.abs().max())
        assert err <= PARAM_TOL, (n, err)
        if mode == "frozen_sgd" and not n.startswith("head."):
            assert torch.equal(p.detach(), before[n]), n
        else:
            assert not torch.equal(p.detach(), before[n]), n
    if mode == "frozen_sgd":
        assert [n for n, p in model.named_parameters() if p.requires_grad] == ["head.weight", "head.bias"]


def test_eval_step_matches_jax():
    cfg_kw = dict(TINY, contrastive=True)
    jmodel = JMAE(JMAEConfig(**cfg_kw))
    rng = np.random.default_rng(2)
    v1 = rng.standard_normal((2, 1, VOL, VOL, VOL)).astype(np.float32)
    noise = rng.random((2, (VOL // PATCH) ** 3)).astype(np.float32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)},
                                     jnp.asarray(v1), jnp.asarray(v1))
    variables = jax.tree.map(np.asarray, variables)

    @jax.jit
    def step_body(variables, view1, noise):  # JAX make_eval_step's body, the noise injected
        out = jmodel.apply(variables, view1, None, mask_ratio=0.75, noise=noise, train=False)
        return j_mae_loss_terms(out, view1, PATCH)[1]

    want = step_body(variables, jnp.asarray(v1), jnp.asarray(noise))

    model = build_model(MAEConfig(**cfg_kw))
    model.load_state_dict(params_from_jax(variables["params"], PATCH, 1, variables["batch_stats"]), strict=True)
    model.train()
    got = make_eval_step(model, PATCH)(model, torch.from_numpy(v1), noise=torch.from_numpy(noise))
    assert model.training  # the step restores the mode it found
    assert set(got) == set(want)
    for k in want:
        w = float(want[k])
        assert abs(float(got[k]) - w) <= 1e-5 * max(abs(w), 1e-12), (k, float(got[k]), w)
    g = torch.Generator().manual_seed(0)
    drawn = make_eval_step(model, PATCH)(model, torch.from_numpy(v1), generator=g)
    assert all(np.isfinite(float(v)) for v in drawn.values())


def test_head_init_2e5_is_a_truncated_normal_from_its_generator():
    _, tcfg = _vit_cfgs()
    tcfg = type(tcfg)(**{**tcfg.__dict__, "embed_dim": 768, "num_heads": 12, "depth": 1})
    model = build_model(tcfg)
    tft.head_init_2e5(model, torch.Generator().manual_seed(49))
    w = model.head.weight.detach()
    assert float(w.abs().max()) <= 4e-5 and torch.count_nonzero(model.head.bias) == 0
    assert 0.8 * 2e-5 < float(w.std()) < 0.95 * 2e-5  # 0.88 sigma: a normal truncated at 2 sigma
    again = build_model(tcfg)
    tft.head_init_2e5(again, torch.Generator().manual_seed(49))
    assert torch.equal(again.head.weight, model.head.weight)
