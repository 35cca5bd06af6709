"""The port's reference-faithful step (utils/ref_faithful.py) against the
JAX package's, on the CPU at the tiny preset in f32: the same weights and
batch statistics (`params_from_jax`), the same VGG16 weights (JAX's seeded
init, bridged), the masking noise of both encoder passes recovered from
JAX's own draws. The loss terms within 1e-5 relative, each gradient within
1e-5 of its largest magnitude, the BatchNorm statistics within 1e-6: the
same f32 arithmetic in another summation order.

The perceptual metric (outside the loss, weight 0 as in the reference) is
held to the port's own VGG run in f64 on the step's volumes within 1e-6;
against JAX's step, within 1e-5 relative plus JAX's own distance from that
f64 value on the same volumes, measured in the test: the JAX package's
XLA:CPU convolutions put its f32 VGG about 1e-4 from f64 on these inputs
(tests/test_torch_port_vgg.py reads 1.1e-5 to 1.4e-5 on its own), the
port's under 1e-7.

Beside JAX, the faithful step against the port's own step on the same
inputs (what `chip_smoke.py` holds on the card): every term but the
perceptual one, which the port's step leaves at 0 without a VGG, and
every gradient within the same limits."""

import copy
import functools
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.models import MODEL_ZOO as JAX_ZOO
from vit_ae_plus_plus_tpu.models import build_model as jax_build_model
from vit_ae_plus_plus_tpu.models import vgg as jax_vgg
from vit_ae_plus_plus_tpu.train.state import TrainState as JaxTrainState
from vit_ae_plus_plus_tpu.utils.ref_faithful import make_reference_faithful_step as jax_faithful_step
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.models.vgg import VGG16Features, make_perceptual_fn
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, make_train_step
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.utils.ref_faithful import make_reference_faithful_step

TINY, VOL, PATCH, B = "contr_mae_vit_tiny_patch4", 16, 4, 2
EMW, CONTR_W = 0.01, 0.001
TERMS = ("loss", "edge_map_loss", "reconstruction_loss", "perceptual_loss", "contr_loss")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keep_grads():
    """An optax transformation whose state is the last gradients and whose
    update is zero: JAX's step then hands back exactly what it computed."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def _jit_init_perceptual(built):
    """JAX's `build_perceptual(None)` with the VGG's init compiled once (the
    eager init compiles op by op); the params it made go to `built`."""
    def build(path=None, seed=0):
        model = jax_vgg.VGG16Features()
        params = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 3, 32, 32)))["params"]
        built.append(params)
        return model, params, jax_vgg.make_perceptual_fn(model, params)

    return build


@pytest.fixture(scope="module")
def jax_run():
    """JAX's faithful step once -> (inputs, weights, metrics, gradients,
    new batch statistics, VGG params and function, the two passes' noise)."""
    cfg = JAX_ZOO[TINY](volume_size=VOL, dtype="float32", attn_impl="xla")
    model = jax_build_model(cfg)
    rng = np.random.default_rng(11)
    v1, v2 = (rng.standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32) for _ in range(2))
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0), "mask": jax.random.PRNGKey(1)},
                            jnp.asarray(v1), jnp.asarray(v2))
    params = jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(np.float32), shapes["params"])
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: (1.0 + (0.1 if "var" in jax.tree_util.keystr(path) else -1.0) * rng.random(a.shape))
        .astype(np.float32), shapes["batch_stats"])
    tx = _keep_grads()
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params),
                          tx=tx)
    key = jax.random.PRNGKey(3)

    def encoder_ids(mdl, a, b):  # the step's two make_rng("mask") calls, in its order
        return mdl.forward_encoder(a, 0.75)[2], mdl.forward_encoder(b, 0.75)[2]

    ids = jax.jit(functools.partial(model.apply, method=encoder_ids))(
        {"params": params, "batch_stats": stats}, jnp.asarray(v1), jnp.asarray(v2),
        rngs={"mask": jax.random.fold_in(key, 0)})
    noise = [np.asarray(i, np.float32) / i.shape[1] for i in ids]  # ranks: argsort gives JAX's permutation
    built = []
    with mock.patch.object(jax_vgg, "build_perceptual", _jit_init_perceptual(built)):
        step = jax_faithful_step(model, PATCH, contr_weight=CONTR_W, run_vgg=True, donate=False)
    state, metrics = step(state, jnp.asarray(v1), jnp.asarray(v2), key, jnp.float32(EMW))
    vgg_params = jax.tree.map(np.asarray, built[0])
    return dict(views=(v1, v2), params=params, stats=stats, noise=noise,
                metrics={k: float(v) for k, v in metrics.items()},
                grads=jax.tree.map(np.asarray, state.opt_state), new_stats=jax.tree.map(np.asarray, state.batch_stats),
                vgg=vgg_params, jax_vgg_fn=jax.jit(jax_vgg.make_perceptual_fn(jax_vgg.VGG16Features(), vgg_params)))


def _port(run):
    model = build_model(MODEL_ZOO[TINY](volume_size=VOL, dtype="float32", attn_impl="plain"))
    model.load_state_dict(params_from_jax(run["params"], PATCH, 1, run["stats"]), strict=True)
    return model, create_train_state(model, make_adamw(1e-3, weight_decay=0.05), seed=0)


def _vgg(run):
    vgg = VGG16Features()
    vgg.load_state_dict(params_from_jax(run["vgg"]), strict=True)
    return vgg


def _faithful(run, model, state, run_vgg=True, seen=None):
    """One faithful step; `seen` collects the volumes the VGG was given."""
    noise = [torch.from_numpy(n) for n in run["noise"]]
    fn = make_perceptual_fn(_vgg(run)) if run_vgg else None
    if seen is not None:
        fn = (lambda f: lambda p, t: seen.extend((p, t)) or f(p, t))(fn)
    step = make_reference_faithful_step(model, PATCH, contr_weight=CONTR_W, run_vgg=run_vgg, perceptual_fn=fn,
                                        noise=noise)
    state, metrics = step(state, *(torch.from_numpy(v) for v in run["views"]), EMW)
    return state, {k: float(v) for k, v in metrics.items()}


def _grad_errs(model, want):
    return {n: float((p.grad - want[n]).abs().max() / want[n].abs().max())
            for n, p in model.named_parameters() if float(want[n].abs().max()) > 0}


def test_faithful_step_matches_jax(jax_run):
    model, state = _port(jax_run)
    seen = []
    state, metrics = _faithful(jax_run, model, state, seen=seen)
    assert set(metrics) == set(TERMS) and metrics["perceptual_loss"] > 0 and state.step == 1
    for k in TERMS[:-2] + TERMS[-1:]:
        want = jax_run["metrics"][k]
        assert abs(metrics[k] - want) <= 1e-5 * abs(want), (k, metrics[k], want)
    pred_vol, target_vol = seen
    exact = float(make_perceptual_fn(copy.deepcopy(_vgg(jax_run)).double())(pred_vol.double(), target_vol.double()))
    assert abs(metrics["perceptual_loss"] - exact) <= 1e-6 * exact
    jax_err = abs(float(jax_run["jax_vgg_fn"](jnp.asarray(pred_vol.numpy()), jnp.asarray(target_vol.numpy()))) - exact)
    want = jax_run["metrics"]["perceptual_loss"]
    assert abs(metrics["perceptual_loss"] - want) <= 1e-5 * want + jax_err, (metrics["perceptual_loss"], want, jax_err)
    want_grads = params_from_jax(jax_run["grads"], PATCH)
    assert set(want_grads) == {n for n, _ in model.named_parameters()}
    errs = _grad_errs(model, want_grads)
    assert max(errs.values()) <= 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    for n, want in params_from_jax({}, PATCH, 1, jax_run["new_stats"]).items():
        np.testing.assert_allclose(model.state_dict()[n].numpy(), want.numpy(), rtol=1e-6, atol=1e-6, err_msg=n)


def test_faithful_step_matches_the_ports_own_step(jax_run):
    """The batched two-view encoder, the separable filters and the
    voxel-space reconstruction of `make_train_step` against the faithful
    graph on the same weights, views and noise."""
    model, state = _port(jax_run)
    state, metrics = _faithful(jax_run, model, state, run_vgg=False)
    assert metrics["perceptual_loss"] == 0.0
    faithful_grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    own, own_state = _port(jax_run)
    noise = torch.from_numpy(np.concatenate(jax_run["noise"]))
    step = make_train_step(own, PATCH, contr_weight=CONTR_W, forward_fn=lambda m, a, b, _g: m(a, b, noise=noise))
    own_state, own_metrics = step(own_state, *(torch.from_numpy(v) for v in jax_run["views"]), EMW)
    for k in ("loss", "edge_map_loss", "reconstruction_loss", "contr_loss"):
        assert abs(own_metrics[k].item() - metrics[k]) <= 1e-5 * abs(metrics[k]), k
    errs = _grad_errs(own, faithful_grads)
    assert max(errs.values()) <= 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:3]


def test_faithful_step_draws_both_passes_noise_from_the_state(jax_run):
    model, state = _port(jax_run)
    step = make_reference_faithful_step(model, PATCH, contr_weight=CONTR_W, run_vgg=False)
    views = [torch.from_numpy(v) for v in jax_run["views"]]
    gen = torch.Generator().set_state(state.generator.get_state())
    state, metrics = step(state, *views, EMW)
    n1 = torch.rand((B, model.cfg.num_patches), generator=gen)
    n2 = torch.rand((B, model.cfg.num_patches), generator=gen)
    again, again_state = _port(jax_run)
    _, want = make_reference_faithful_step(again, PATCH, contr_weight=CONTR_W, run_vgg=False, noise=(n1, n2))(
        again_state, *views, EMW)
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v) for k, v in want.items()}
    assert state.generator.get_state().equal(gen.get_state())
