"""The port's LayerNorm options against the JAX package, on the same numpy
inputs and weights on the CPU: the fused LayerNorm+Dense op and the fused
LayerNorm (both through their plain versions here; the JAX side runs its
Pallas kernels in interpret mode), `Block` and the ViT with
`ln_fusion="on"` or `ln_dtype="bfloat16"`, and one MAE training step with
`ln_fusion="on"`.

Tolerances:
- f32: 1e-5 relative to the largest magnitude. Both sides compute the same
  f32 arithmetic (fast-variance statistics, f32 products) in another
  summation order (measured at most 5e-7).
- bf16 outputs (y, dx): two bf16 spacings at the largest magnitude. Both
  sides round the same f32 values to bf16; a statistic summed in another
  order can flip the rounding of an element by one spacing (measured 0).
  bf16 runs' parameter gradients are f32 sums of exact products of the same
  bf16 operands: 1e-5 relative (measured 2e-7).
- `ln_dtype="bfloat16"`: every LayerNorm op rounds to bf16 on both sides,
  and JAX and PyTorch may keep an intermediate unrounded in another place:
  2e-2 relative on the features, the bound of tests/test_ln_dtype.py
  against the f32 graph, read here against JAX's own bf16 graph.
- the MAE step: test_torch_port_mae.py's bounds (loss terms 1e-5 relative,
  each gradient 1e-4 of its largest magnitude, BatchNorm statistics 1e-6).
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import MAEConfig as JaxMAEConfig
from vit_ae_plus_plus_tpu.configs import ViTConfig as JaxViTConfig
from vit_ae_plus_plus_tpu.kernels.fused_ln import fused_layernorm as jax_fused_layernorm
from vit_ae_plus_plus_tpu.kernels.fused_ln_dense import fused_ln_dense as jax_fused_ln_dense
from vit_ae_plus_plus_tpu.models import MaskedAutoencoderViT3D as JaxMAE
from vit_ae_plus_plus_tpu.models import build_model as jax_build_model
from vit_ae_plus_plus_tpu.models.vit import Block as JaxBlock
from vit_ae_plus_plus_tpu.models.vit import FusedLayerNorm as JaxFusedLayerNorm
from vit_ae_plus_plus_tpu.train import make_adamw as jax_make_adamw
from vit_ae_plus_plus_tpu.train import make_train_step as jax_make_train_step
from vit_ae_plus_plus_tpu.train.objective import mae_loss_terms as jax_mae_loss_terms
from vit_ae_plus_plus_tpu.train.state import TrainState as JaxTrainState
from vit_ae_plus_plus_torch.configs import MAEConfig, ViTConfig
from vit_ae_plus_plus_torch.kernels import (
    fused_layernorm,
    fused_ln_dense,
    layernorm_bwd_plain,
    layernorm_plain,
    ln_dense_bwd_plain,
    ln_dense_plain,
)
from vit_ae_plus_plus_torch.kernels.flash_attention import _bf16_spacing
from vit_ae_plus_plus_torch.models import VisionTransformer3D, build_model
from vit_ae_plus_plus_torch.models.vit import Block, FusedLayerNorm
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

R, C, F = 100, 64, 192  # ragged rows, as tests/test_fused_ln_dense.py
F32_TOL = 1e-5
LN_DTYPE_TOL = 2e-2
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _np(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _assert_out_close(got: torch.Tensor, want, what: str):
    """An output in the compute dtype: F32_TOL relative in f32, two bf16
    spacings at the largest magnitude in bf16."""
    g, w = got.detach().float().numpy(), np.asarray(jnp.asarray(want).astype(jnp.float32))
    if got.dtype == torch.bfloat16:
        tol = 2 * _bf16_spacing(float(np.abs(w).max()))
        assert np.abs(g - w).max() <= tol, (what, np.abs(g - w).max(), tol)
    else:
        assert _rel(g, w) <= F32_TOL, (what, _rel(g, w))


def _ln_dense_inputs():
    return dict(x=_np((R, C), 0, 2.0, 1.0), gamma=_np(C, 1, 0.1, 1.0), beta=_np(C, 2, 0.1),
                w=_np((C, F), 3, C**-0.5), b=_np(F, 4, 0.1), dy=_np((R, F), 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ln_dense_matches_jax(dtype):
    """Forward and all five gradients of sum(y * dy); W in (C, F) on the
    JAX side, nn.Linear's (F, C) in the port."""
    a = _ln_dense_inputs()
    xj = jnp.asarray(a["x"]).astype(JDT[dtype])

    def loss(x, gamma, beta, w, b):
        y = jax_fused_ln_dense(x, gamma, beta, w, b, 1e-6, True)
        return jnp.sum(y.astype(jnp.float32) * a["dy"]), y

    (_, want_y), want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        xj, *(jnp.asarray(a[k]) for k in ("gamma", "beta", "w", "b")))

    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype).requires_grad_()
    params = [torch.from_numpy(v.copy()).requires_grad_() for v in (a["gamma"], a["beta"], a["w"].T, a["b"])]
    y = fused_ln_dense(x, *params, 1e-6)
    assert y.dtype == dtype and y.shape == (R, F)
    _assert_out_close(y, want_y, "y")
    (y.float() * torch.from_numpy(a["dy"])).sum().backward()
    assert x.grad.dtype == dtype
    _assert_out_close(x.grad, want[0], "dx")
    for name, p, g in zip(("gamma", "beta", "w", "b"), params, want[1:]):
        assert p.grad.dtype == torch.float32, name
        got = p.grad.numpy().T if name == "w" else p.grad.numpy()
        assert _rel(got, g) <= F32_TOL, (name, _rel(got, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_layernorm_matches_jax(dtype):
    """Forward and the gradients of sum(sin(y)) against the Pallas kernels
    in interpret mode (tests/test_fused_ln.py's loss), ragged rows."""
    x_np, gamma, beta = _np((3, 70, 256), 6, 2.0, 1.0), _np(256, 7, 0.1, 1.0), _np(256, 8, 0.1)
    xj = jnp.asarray(x_np).astype(JDT[dtype])

    def loss(x, s, b):
        y = jax_fused_layernorm(x, s, b, 1e-6, True)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, want_y), want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        xj, jnp.asarray(gamma), jnp.asarray(beta))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype).requires_grad_()
    s, b = (torch.from_numpy(v.copy()).requires_grad_() for v in (gamma, beta))
    y = fused_layernorm(x, s, b, 1e-6)
    assert y.dtype == dtype and y.shape == x.shape
    _assert_out_close(y, want_y, "y")
    torch.sin(y.float()).sum().backward()
    _assert_out_close(x.grad, want[0], "dx")
    for name, p, g in (("gamma", s, want[1]), ("beta", b, want[2])):
        assert _rel(p.grad.numpy(), g) <= F32_TOL, (name, _rel(p.grad.numpy(), g))


def test_plain_versions_keep_the_fast_variance():
    """The plain versions follow the TPU kernels (E[x^2] - mean^2, not
    clamped), not F.layer_norm's two-pass variance; their backward is the
    autograd gradient of the forward in f64."""
    x = torch.from_numpy(_np((5, 64), 9, 1e-3, 100.0)).double()  # mean 100, spread 1e-3
    gamma, beta = (torch.from_numpy(_np(64, s, 0.1, 1.0)).double() for s in (10, 11))
    _, mu, rstd = layernorm_plain(x, gamma, beta, 1e-6)
    var = (x * x).mean(-1) - x.mean(-1) ** 2
    torch.testing.assert_close(rstd, torch.rsqrt(var + 1e-6), rtol=0, atol=0)
    xr = x.clone().requires_grad_()
    dy = torch.from_numpy(_np((5, 64), 12)).double()
    (layernorm_plain(xr, gamma, beta, 1e-6)[0] * dy).sum().backward()
    torch.testing.assert_close(layernorm_bwd_plain(x, gamma, mu, rstd, dy), xr.grad, rtol=1e-9, atol=1e-9)
    w, b = (torch.from_numpy(_np(s, 13, 0.1)).double() for s in ((32, 64), 32))
    y, mu2, rstd2 = ln_dense_plain(x, gamma, beta, w, b, 1e-6)
    dy2 = torch.from_numpy(_np((5, 32), 14)).double()
    dx, dln = ln_dense_bwd_plain(x, gamma, w, dy2, mu2, rstd2)
    torch.testing.assert_close(dln, dy2 @ w)
    xr = x.clone().requires_grad_()
    (ln_dense_plain(xr, gamma, beta, w, b, 1e-6)[0] * dy2).sum().backward()
    torch.testing.assert_close(dx, xr.grad, rtol=1e-9, atol=1e-9)


def test_fused_layernorm_module_matches_jax_module():
    """`FusedLayerNorm` against `models/vit.py::FusedLayerNorm` of the JAX
    package, whose CPU path is jnp with the two-pass variance: 2e-5, the
    bound of tests/test_fused_ln.py for the same comparison."""
    x = _np((2, 10, 64), 15)
    scale, bias = _np(64, 16, 0.1, 1.0), _np(64, 17, 0.1)
    want = JaxFusedLayerNorm(epsilon=1e-6).apply({"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    m = FusedLayerNorm(64, eps=1e-6, dtype=torch.bfloat16)
    sd = params_from_jax({"norm": {"scale": scale, "bias": bias}}, 4)  # flax names -> weight, bias
    m.load_state_dict({k.removeprefix("norm."): v for k, v in sd.items()}, strict=True)
    got = m(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16  # cast to the module's dtype, as flax's
    m.dtype = torch.float32
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def _block_params(dim, seed):
    x = jnp.zeros((1, 5, dim))
    params = JaxBlock(num_heads=4, attn_impl="xla", ln_fusion="off").init(jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        if jax.tree_util.keystr(path).endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, params))


def test_block_ln_fusion_on_matches_jax():
    """Block(ln_fusion='on') output and every gradient (x and the ten
    parameters) against JAX's fused Block on the same weights, and the same
    weights through the port's unfused Block."""
    dim = 64
    params = _block_params(dim, 18)
    x_np, seed = _np((2, 33, dim), 19), _np((2, 33, dim), 20)
    jblock = JaxBlock(num_heads=4, attn_impl="xla", ln_fusion="on")

    def loss(p, x):
        y = jblock.apply({"params": p}, x)
        return jnp.sum(y * seed), y

    grad_fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, want_y), (want_p, want_x) = grad_fn(params, jnp.asarray(x_np))
    want_grads = params_from_jax(jax.tree.map(np.asarray, want_p), 4)
    outs = {}
    for mode in ("on", "off"):
        block = Block(dim, 4, attn_impl="plain", ln_fusion=mode)
        block.load_state_dict(params_from_jax(params, 4), strict=True)
        x = torch.from_numpy(x_np.copy()).requires_grad_()
        y = block(x)
        (y * torch.from_numpy(seed)).sum().backward()
        outs[mode] = y.detach().numpy()
        assert _rel(y.detach().numpy(), want_y) <= F32_TOL, mode
        assert _rel(x.grad.numpy(), want_x) <= F32_TOL, mode
        named = dict(block.named_parameters())
        assert set(named) == set(want_grads)
        for name, g in want_grads.items():
            assert _rel(named[name].grad.numpy(), g.numpy()) <= F32_TOL, (mode, name)
    assert _rel(outs["on"], outs["off"]) <= F32_TOL


@pytest.mark.parametrize("option", [{"ln_fusion": "on"}, {"ln_dtype": "bfloat16"}])
def test_vit_forward_features_with_ln_options_matches_jax(option):
    """The tiny ViT (16^3, patch 4, width 24, depth 2) with each LayerNorm
    option, f32 compute, on JAX's weights: JAX's graph with the same option
    and the port's agree (F32_TOL fused, LN_DTYPE_TOL with bf16 stats)."""
    kw = dict(volume_size=16, patch_size=4, embed_dim=24, depth=2, num_heads=3, num_classes=0, **option)
    jmodel = jax_build_model(JaxViTConfig(**kw))
    x = _np((3, 1, 16, 16, 16), 21)
    params = jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 16, 16, 16)))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + _np(np.shape(v), 22, 0.05), params)
    features = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, method=jmodel.forward_features))
    want = np.asarray(features(params, jnp.asarray(x)))
    port = VisionTransformer3D(ViTConfig(**kw))
    port.load_state_dict(params_from_jax(params, 4), strict=True)
    with torch.inference_mode():
        got = port.eval().forward_features(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= (F32_TOL if "ln_fusion" in option else LN_DTYPE_TOL), _rel(got, want)


def test_mae_step_ln_fusion_on_matches_jax():
    """One contrastive MAE step with MAEConfig(ln_fusion='on') through the
    port's `make_train_step` against the JAX package's `make_train_step`
    (loss terms, BatchNorm statistics) and the gradient of its loss (every
    gradient), on the same weights, volumes and masking noise."""
    kw = dict(volume_size=16, patch_size=4, embed_dim=24, depth=2, num_heads=3, decoder_embed_dim=12,
              decoder_depth=1, decoder_num_heads=2, contrastive=True, ln_fusion="on")
    v1, v2 = _np((2, 1, 16, 16, 16), 23), _np((2, 1, 16, 16, 16), 24)
    noise = np.random.default_rng(25).random((4, 64)).astype(np.float32)
    jmodel = JaxMAE(JaxMAEConfig(**kw))
    variables = jmodel.init({"params": jax.random.PRNGKey(1), "mask": jax.random.PRNGKey(2)},
                            jnp.asarray(v1), jnp.asarray(v2))
    rng = np.random.default_rng(26)

    def leaf(path, v):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']") or key.endswith("['var']"):
            return (1.0 + 0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
        return (0.05 * rng.standard_normal(np.shape(v))).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(leaf, jax.tree.map(np.asarray, variables))
    params, bs = variables["params"], variables["batch_stats"]

    def jfwd(var, a, b, _rng=None):
        out, mutated = jmodel.apply(var, a, b, mask_ratio=0.75, noise=jnp.asarray(noise),
                                    mutable=["batch_stats"])
        return out, mutated["batch_stats"]

    tx = jax_make_adamw(1e-3)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bs,
                           opt_state=tx.init(params), tx=tx)
    jstep = jax_make_train_step(jmodel, 4, contr_weight=0.1, donate=False, forward_fn=jfwd)
    jstate, want = jstep(jstate, jnp.asarray(v1), jnp.asarray(v2), jax.random.PRNGKey(0), jnp.float32(0.01))

    def loss_fn(p):
        out, _ = jfwd({"params": p, "batch_stats": bs}, jnp.asarray(v1), jnp.asarray(v2))
        return jax_mae_loss_terms(out, jnp.asarray(v1), 4, edge_map_weight=0.01, contr_weight=0.1)[0]

    grads = jax.jit(jax.grad(loss_fn))(params)

    port = build_model(MAEConfig(**kw))
    port.load_state_dict(params_from_jax(params, 4, 1, bs), strict=True)
    state = create_train_state(port, make_adamw(1e-3))
    step = make_train_step(port, 4, contr_weight=0.1,
                           forward_fn=lambda m, a, b, _g: m(a, b, noise=torch.from_numpy(noise)))
    state, got = step(state, torch.from_numpy(v1), torch.from_numpy(v2), 0.01)
    for k in set(want) - {"grad_norm"}:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads), 4)
    named = dict(port.named_parameters())
    assert set(want_grads) == set(named)
    for name, g in want_grads.items():
        assert _rel(named[name].grad.numpy(), g.numpy()) <= 1e-4, name
    for name, v in params_from_jax({}, 4, batch_stats=jax.device_get(jstate.batch_stats)).items():
        np.testing.assert_allclose(state.batch_stats[name].numpy(), np.asarray(v), rtol=0, atol=1e-6, err_msg=name)


def test_ln_options_warn_together_and_reject_bad_modes():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        VisionTransformer3D(ViTConfig(embed_dim=32, depth=1, num_heads=2, ln_fusion="on", ln_dtype="bfloat16"))
    assert any("ln_dtype" in str(w.message) and "fused" in str(w.message) for w in caught)
    for kw in ({"ln_fusion": "on"}, {"ln_dtype": "bfloat16"}, {"ln_fusion": "off"}):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            Block(32, 2, **kw)
        assert not [w for w in caught if "ln_dtype" in str(w.message)], kw
    for make in (lambda: ViTConfig(ln_fusion="yes"), lambda: MAEConfig(ln_fusion="ON"),
                 lambda: Block(32, 2, ln_fusion="always")):
        with pytest.raises(ValueError, match="ln_fusion"):
            make()
    assert MAEConfig(ln_fusion="on", ln_dtype="bfloat16").encoder_vit_config() == ViTConfig(
        ln_fusion="on", ln_dtype="bfloat16")
    assert not Block(32, 2, ln_fusion="auto").fused  # 'auto' never fuses, as in JAX
