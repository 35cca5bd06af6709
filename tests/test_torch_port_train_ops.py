"""The port's masking, edge filters, losses and objective against the JAX
package, on the same numpy inputs on the CPU.

Tolerances: masking is pure data movement (exact). The filters and losses
run the same f32 arithmetic (banded matmuls, f32 reductions) in another
summation order: 1e-5 relative with a 1e-6 absolute floor (the filters' sums
over 11^3 taps reach magnitudes of ~10, where f32 spacing is ~1e-6)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.ops import filters as jax_filters
from vit_ae_plus_plus_tpu.ops import losses as jax_losses
from vit_ae_plus_plus_tpu.ops import random_masking as jax_random_masking
from vit_ae_plus_plus_tpu.ops import restore_tokens as jax_restore_tokens
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_mae_loss_terms
from vit_ae_plus_plus_tpu.train.optim import make_adamw as jax_make_adamw
from vit_ae_plus_plus_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from vit_ae_plus_plus_torch.configs import MAEConfig
from vit_ae_plus_plus_torch.models import build_model
from vit_ae_plus_plus_torch.ops import (
    edge_map_loss,
    gaussian_blur_3d,
    gaussian_kernel_1d,
    masked_mse_loss,
    negative_cosine_loss,
    random_masking,
    restore_tokens,
    sobel_edges_3d,
)
from vit_ae_plus_plus_torch.train import (
    create_train_state,
    make_adamw,
    make_train_step,
    mae_loss_terms,
    warmup_cosine_schedule,
)

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("l,ratio", [(64, 0.75), (1728, 0.75), (27, 0.5)])
def test_masking_and_restore_match_jax(l, ratio):
    """Exact: stable argsorts of the same noise, ties included."""
    x = _np((3, l, 5), 0)
    noise = np.random.default_rng(1).random((3, l)).astype(np.float32)
    noise[:, : l // 3] = 0.5  # ties: both sorts are stable
    want = jax_random_masking(jnp.asarray(x), ratio, noise=jnp.asarray(noise))
    got = random_masking(torch.from_numpy(x), ratio, torch.from_numpy(noise))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape[1] == int(l * (1 - ratio))  # 432 of 1,728 at the flagship shape
    token = _np((1, 1, 5), 2)
    want_full = jax_restore_tokens(want[0], jnp.asarray(token), want[2])
    got_full = restore_tokens(got[0], torch.from_numpy(token), got[2])
    np.testing.assert_array_equal(got_full.numpy(), np.asarray(want_full))


def test_gaussian_taps_are_the_references_linspace():
    np.testing.assert_array_equal(gaussian_kernel_1d(2.0), jax_filters.gaussian_kernel_1d(2.0))
    assert len(gaussian_kernel_1d(2.0)) == 11


@pytest.mark.parametrize("c", [1, 4])
def test_sobel_and_blur_match_jax(c):
    vol = _np((2, c, 12, 12, 12), c)
    want_edges = np.asarray(jax_filters.sobel_edges_3d(jnp.asarray(vol)))
    want_blur = np.asarray(jax_filters.gaussian_blur_3d(jnp.asarray(vol), 2.0))
    got_edges = sobel_edges_3d(torch.from_numpy(vol))
    assert got_edges.shape == (2, 12, 12, 12)
    np.testing.assert_allclose(got_edges.numpy(), want_edges, **TOL)
    np.testing.assert_allclose(gaussian_blur_3d(torch.from_numpy(vol), 2.0).numpy(), want_blur, **TOL)


def test_sobel_gradient_is_finite_on_flat_volumes():
    """The safe sqrt: zero subgradient where the volume is locally flat, as in
    JAX (a bare torch.sqrt gives inf there and the step turns to NaN)."""
    def grad(v):
        t = torch.from_numpy(v).requires_grad_()
        sobel_edges_3d(t).sum().backward()
        return t.grad.numpy()

    zeros = np.zeros((1, 1, 8, 8, 8), np.float32)
    np.testing.assert_array_equal(grad(zeros), 0.0)
    g1 = grad(np.ones_like(zeros))
    assert np.isfinite(g1).all()
    np.testing.assert_array_equal(g1[..., 2:-2, 2:-2, 2:-2], 0.0)
    mixed = zeros.copy()
    mixed[..., :4] = _np((1, 1, 8, 8, 4), 3)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_filters.sobel_edges_3d(v)))(jnp.asarray(mixed)))
    got = grad(mixed)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_losses_match_jax(dtype):
    """bf16 inputs reduce in f32 on both sides (at_least_f32)."""
    def pair(shape, seed):
        x = _np(shape, seed)
        if dtype == "bfloat16":
            t = torch.from_numpy(x).to(torch.bfloat16)
            return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return torch.from_numpy(x), jnp.asarray(x)

    (pt, pj), (tt, tj) = pair((2, 64, 48), 0), pair((2, 64, 48), 1)
    mask = (np.random.default_rng(2).random((2, 64)) > 0.25).astype(np.float32)
    got = masked_mse_loss(pt, tt, torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jax_losses.masked_mse_loss(pj, tj, jnp.asarray(mask))), **TOL)
    np.testing.assert_allclose(float(edge_map_loss(pt, tt)), float(jax_losses.edge_map_loss(pj, tj)), **TOL)
    rows = [pair((34, 24), s) for s in range(4)]
    want = jax_losses.negative_cosine_loss(*(j for _, j in rows))
    np.testing.assert_allclose(float(negative_cosine_loss(*(t for t, _ in rows))), float(want), **TOL)


def test_negative_cosine_clamps_each_norm():
    """A zero row: each norm clamps at eps on its own, as in JAX."""
    a = _np((4, 8), 0)
    a[1] = 0.0
    b = _np((4, 8), 1) * 1e-5
    want = float(jax_losses.negative_cosine_loss(*(jnp.asarray(x) for x in (a, a, b, b))))
    got = float(negative_cosine_loss(*(torch.from_numpy(x) for x in (a, a, b, b))))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("norm_pix_loss", [False, True])
@pytest.mark.parametrize("c", [1, 4])
def test_mae_loss_terms_match_jax(norm_pix_loss, c):
    """The composite objective on the same outputs: recon over removed
    patches (volume space without norm_pix_loss), Sobel of the raw
    prediction against that of the blurred target, per-token contrast."""
    p, s = 4, 16
    out_np = {
        "pred": _np((2, 64, p**3 * c), 0),
        "mask": (np.random.default_rng(1).random((2, 64)) > 0.25).astype(np.float32),
        **{k: _np((34, 24), i + 2) for i, k in enumerate(("p1", "p2", "z1", "z2"))},
    }
    view1 = _np((2, c, s, s, s), 9)
    kw = dict(edge_map_weight=0.01, contr_weight=0.1, norm_pix_loss=norm_pix_loss)
    _, want = jax_mae_loss_terms({k: jnp.asarray(v) for k, v in out_np.items()}, jnp.asarray(view1), p, **kw)
    _, got = mae_loss_terms({k: torch.from_numpy(v) for k, v in out_np.items()},
                            torch.from_numpy(view1), p, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    # a weight without a perceptual function adds nothing, as in the JAX
    # package (tests/test_torch_port_vgg.py holds the term itself)
    _, no_fn = mae_loss_terms({k: torch.from_numpy(v) for k, v in out_np.items()}, torch.from_numpy(view1), p,
                              perceptual_weight=1.0, **kw)
    assert float(no_fn["perceptual_loss"]) == 0.0 and float(no_fn["loss"]) == float(got["loss"])


@pytest.mark.parametrize("clip_grad", [None, 0.5])
def test_adamw_matches_optax(clip_grad):
    """Four updates on the same gradients (global norm about 4.6, so 0.5
    clips every one): AdamW(0.9, 0.95) with decay for ndim > 1 only (the
    token decays, the bias does not), the warmup-cosine rate of each
    update's count from 0 (the first is 0) and optax's clip_by_global_norm.
    f32 on both sides, another order of operations: 1e-6 relative."""
    init = {"w": _np((4, 3), 20), "b": _np((3,), 21), "tok": _np((1, 1, 3), 22)}
    grads = [{k: _np(v.shape, 30 + 3 * i + j) for j, (k, v) in enumerate(init.items())} for i in range(4)]
    schedule = (1e-2, 1e-4, 1.0, 3.0, 2)  # base, min, warmup epochs, epochs, steps per epoch

    tx = jax_make_adamw(jax_schedule(*schedule), weight_decay=0.05, clip_grad=clip_grad)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_adamw(warmup_cosine_schedule(*schedule), weight_decay=0.05, clip_grad=clip_grad)(module)
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_unported_options_raise():
    """The options once refused here are ported: `accum_iter` > 1 builds
    the accumulating AdamW (tests/test_torch_port_accum.py), and a step
    with a perceptual weight but no function takes a finite step with a
    zero term, as JAX's does."""
    from vit_ae_plus_plus_torch.train.optim import MultiSteps

    tiny = dict(volume_size=8, patch_size=4, embed_dim=12, depth=1, num_heads=2,
                decoder_embed_dim=8, decoder_depth=1, decoder_num_heads=2)
    model = build_model(MAEConfig(**tiny))
    assert isinstance(make_adamw(1e-3, accum_iter=2)(model), MultiSteps)
    step = make_train_step(model, 4, perceptual_weight=0.1)
    view = torch.from_numpy(_np((1, 1, 8, 8, 8), 40))
    _, metrics = step(create_train_state(model, make_adamw(1e-3)), view, view, 0.0)
    assert float(metrics["perceptual_loss"]) == 0.0 and np.isfinite(float(metrics["loss"]))
    # the LayerNorm options are ported: each builds and takes a finite step
    for override in ({"ln_fusion": "on"}, {"ln_dtype": "bfloat16"}):
        model = build_model(MAEConfig(**tiny, **override))
        assert all(blk.fused == (override.get("ln_fusion") == "on") for blk in model.blocks), override
        _, metrics = make_train_step(model, 4)(create_train_state(model, make_adamw(1e-3)), view, view, 0.0)
        assert np.isfinite(float(metrics["loss"])), override
