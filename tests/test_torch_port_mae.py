"""The port's MAE and training step against the JAX package, on the same
numpy weights, batch statistics, volumes and masking noise, on the CPU.

- f32 forward (`pred`, `mask`, `ids_restore`, `latent`, `p1/p2/z1/z2`):
  1e-5 absolute and relative, as the ViT tests: the same f32 arithmetic,
  only the order of summation differs (measured about 1.5e-6).
- one f32 step (loss terms, every gradient, the BatchNorm statistics): loss
  terms 1e-5 relative; each gradient within 1e-4 of its largest magnitude
  (measured 1.2e-6: backward sums over the batch in another order, and the
  edge loss's squared Sobel maps amplify rounding); statistics 1e-6.

The 10-step f64 trajectory is in tests/test_torch_port_train_trajectory.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import MAEConfig as JaxMAEConfig
from vit_ae_plus_plus_tpu.models import MaskedAutoencoderViT3D as JaxMAE
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_mae_loss_terms
from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import MaskedAutoencoderViT3D, build_model
from vit_ae_plus_plus_torch.train import (
    create_train_state,
    make_adamw,
    make_train_step,
)
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

B, VOL, PATCH = 2, 16, 4
TINY = dict(volume_size=VOL, patch_size=PATCH, embed_dim=24, depth=2, num_heads=3,
            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2)
CASES = {  # id -> (contrastive, in_chans, use_proj)
    "plain_mae": (False, 1, False),
    "contrastive_mae": (True, 1, True),
    "contrastive_mae_egd_c4": (True, 4, False),
}
EMW, CONTR_W = 0.01, 0.1
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg_kw(case, dtype="float32"):
    contrastive, in_chans, use_proj = CASES[case]
    return dict(TINY, in_chans=in_chans, contrastive=contrastive, use_proj=use_proj, dtype=dtype)


def _data(case, steps=1, seed=7):
    contrastive, in_chans, _ = CASES[case]
    rng = np.random.default_rng(seed)
    shape = (steps, B, in_chans, VOL, VOL, VOL)
    v1 = rng.standard_normal(shape).astype(np.float32)
    v2 = rng.standard_normal(shape).astype(np.float32)
    rows = 2 * B if contrastive else B
    noise = rng.random((steps, rows, (VOL // PATCH) ** 3)).astype(np.float32)
    return v1, v2, noise


def _jax_variables(case, v1, v2, dtype=np.float32):
    """JAX init with randomised leaves (LayerNorm and BatchNorm scales near
    1, the rest small, BatchNorm statistics away from their 0/1 start)."""
    model = JaxMAE(JaxMAEConfig(**_cfg_kw(case, "float64" if dtype == np.float64 else "float32")))
    args = (jnp.asarray(v1), jnp.asarray(v2)) if CASES[case][0] else (jnp.asarray(v1),)
    variables = model.init({"params": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)}, *args)
    rng = np.random.default_rng(3)

    def leaf(path, x):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or key.endswith("['var']"):
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(dtype)
        return (0.05 * rng.standard_normal(x.shape)).astype(dtype)

    variables = jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))
    return model, variables["params"], variables.get("batch_stats", {})


def _port(case, params, batch_stats, dtype=torch.float32):
    model = build_model(MAEConfig(**_cfg_kw(case, "float64" if dtype == torch.float64 else "float32")))
    model.to(dtype).load_state_dict(
        params_from_jax(params, PATCH, CASES[case][1], batch_stats), strict=True
    )
    return model


def _jax_forward(model, variables, v1, v2, noise):
    """-> (outputs, new batch_stats or None), as the JAX step's forward_fn."""
    kwargs = {"mutable": ["batch_stats"]} if "batch_stats" in variables else {}
    result = model.apply(variables, jnp.asarray(v1), jnp.asarray(v2) if model.cfg.contrastive else None,
                         mask_ratio=0.75, noise=jnp.asarray(noise), **kwargs)
    outputs, mutated = result if kwargs else (result, {})
    return outputs, mutated.get("batch_stats")


def _rel(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("case", ["plain_mae", "contrastive_mae"])
def test_mae_outputs_match_jax(case):
    v1, v2, noise = (x[0] for x in _data(case))
    jmodel, params, bs = _jax_variables(case, v1, v2)
    variables = {"params": params, **({"batch_stats": bs} if bs else {})}
    want, _ = _jax_forward(jmodel, variables, v1, v2, noise)
    port = _port(case, params, bs).train()
    assert isinstance(port, MaskedAutoencoderViT3D)
    got = port(torch.from_numpy(v1), torch.from_numpy(v2) if CASES[case][0] else None,
               noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["ids_restore"].numpy(), np.asarray(want["ids_restore"]))
    np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    assert int(got["mask"].sum()) == B * (64 - int(64 * 0.25))
    for k in set(got) - {"ids_restore", "mask"}:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), **TOL, err_msg=k)
    if CASES[case][0]:
        assert got["z1"].grad_fn is None and got["p1"].grad_fn is not None


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_matches_jax(case):
    """Loss terms, every gradient and the BatchNorm statistics of one f32
    step; the projector (built, never applied) gets zero gradients."""
    contrastive = CASES[case][0]
    v1, v2, noise = (x[0] for x in _data(case, seed=11))
    jmodel, params, bs = _jax_variables(case, v1, v2)

    def loss_fn(p):
        variables = {"params": p, **({"batch_stats": bs} if bs else {})}
        out, new_bs = _jax_forward(jmodel, variables, v1, v2, noise)
        total, metrics = jax_mae_loss_terms(out, jnp.asarray(v1), PATCH, edge_map_weight=EMW,
                                            contr_weight=CONTR_W if contrastive else 0.0)
        return total, (metrics, new_bs or {})

    (_, (want, want_bs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    port = _port(case, params, bs)
    state = create_train_state(port, make_adamw(1e-3))
    step = make_train_step(port, PATCH, contr_weight=CONTR_W if contrastive else 0.0,
                           forward_fn=lambda m, a, b, _g: m(a, b, noise=torch.from_numpy(noise)))
    state, got = step(state, torch.from_numpy(v1), torch.from_numpy(v2), EMW)
    assert state.step == 1
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads), PATCH, CASES[case][1])
    named = dict(port.named_parameters())
    assert set(want_grads) == set(named)
    for name, g in want_grads.items():
        assert _rel(named[name].grad.numpy(), g.numpy()) <= 1e-4, name
    total_norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in want_grads.values()))
    np.testing.assert_allclose(float(got["grad_norm"]), total_norm, rtol=1e-5)
    if CASES[case][2]:
        assert all(float(named[n].grad.abs().max()) == 0.0 for n in named if "projection_head" in n)
    for name, v in params_from_jax({}, PATCH, batch_stats=jax.tree.map(np.asarray, want_bs)).items():
        np.testing.assert_allclose(state.batch_stats[name].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_init_weights_follows_the_jax_init():
    """Xavier-uniform Linear weights (the patch embed as its (p^3 C, D)
    matrix) within their bound, zero biases, N(0, 0.02) tokens, LayerNorm
    1/0, and PyTorch's Linear default bound 1/sqrt(fan_in) in the heads."""
    model = build_model(MAEConfig(**_cfg_kw("contrastive_mae")))
    model.init_weights(torch.Generator().manual_seed(0))
    p = {name: t.detach() for name, t in model.named_parameters()}

    def in_bound(name, lim):
        top = float(p[name].abs().max())
        return 0.8 * lim < top <= lim

    assert in_bound("blocks.0.attn.qkv.weight", np.sqrt(6.0 / (24 + 72)))
    assert in_bound("patch_embed.proj.weight", np.sqrt(6.0 / (64 + 24)))
    assert in_bound("predictor.0.weight", 1 / np.sqrt(24))
    assert in_bound("projection_head.3.weight", 1 / np.sqrt(24))
    for name, t in p.items():
        if name.endswith(".bias") and ("attn" in name or "mlp" in name or "decoder_" in name):
            assert float(t.abs().max()) == 0.0, name
    np.testing.assert_array_equal(p["norm.weight"].detach().numpy(), 1.0)
    for token in ("cls_token", "mask_token"):
        assert 0.005 < float(p[token].std()) < 0.04
