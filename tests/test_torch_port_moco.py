"""The port's MoCo-v3 baseline against the JAX package's, on the CPU.

- `make_lars` against the JAX package's optax chain in f64 over a tree of
  2-D, 1-D, 3-D and all-zero leaves, 5 updates under a warmup-cosine
  schedule: parameters and traces within 1e-12 of their largest magnitude.
- `MoCoMLP`, `MoCoViT3D` and `MoCoResNet3D` (the JAX modules' seeded numpy
  weights and batch statistics through `params_from_jax`), f32, training
  and eval mode: outputs with and without the predictor, trunk features and
  the updated running statistics within 1e-5 of the largest reference
  magnitude (train-mode ResNet: 1e-3, see `F32_TOL`).
- The heads in bf16 against JAX's compiled with XLA's excess precision off
  (`xla_allow_excess_precision`, as tests/test_torch_port_resnet.py): the
  ViT projector and predictor, and the ResNet predictor without its last
  BatchNorm, forward in training mode and backward; two controls (the head
  in f32; BatchNorm's output rounded to bf16, where a BatchNorm output is
  not rounded next anyway) must miss.
- `info_nce` and `moco_loss` in f64 (loss and the base encoder's running
  statistics within 1e-12), JAX's `moco_loss` read through its jitted step
  with m = 1, which the trajectory below shares.
- 10 f64 steps of `make_moco_train_step` with the cosine m and a warmup,
  against the JAX package's jitted step from the same weights and views:
  losses within 1e-9 relative at every step; base parameters, momentum
  parameters and both sets of BatchNorm statistics within rtol 1e-9 /
  atol 1e-11 (tests/test_moco_trajectory.py's limits). The control, the
  EMA applied after the optimizer step (m one step late), must miss after
  3 steps.

Sizes: ViT depth 2, width 24, 3 heads, 16^3 volumes at patch 4; heads of
mlp_dim 16 and dim 8; ResNet-10 at a quarter width; batch 4.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.models import moco as jm
from vit_ae_plus_plus_tpu.models import resnet3d as jr
from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk
from vit_ae_plus_plus_tpu.train.optim import make_lars as jax_make_lars
from vit_ae_plus_plus_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from vit_ae_plus_plus_torch.configs import DataConfig
from vit_ae_plus_plus_torch.models import moco as tm
from vit_ae_plus_plus_torch.models import resnet3d as tr
from vit_ae_plus_plus_torch.models.vit import FlaxBatchNorm
from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk
from vit_ae_plus_plus_torch.train import warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.train.optim import make_lars

B, VOL, PATCH, DIM, MLP_DIM = 4, 16, 4, 8, 16
VIT = dict(patch_size=PATCH, embed_dim=24, depth=2, num_heads=3)
NARROW = (16, 32, 64, 128)  # ResNet-10's stage widths at a quarter
# in training mode the ResNet trunk (f32 in both packages) normalises its
# last stage over one voxel a volume at 16^3, four a batch, which amplifies
# the convolutions' summation order: the port reads 2.0e-4 on q against the
# JAX package, and 1.5e-4 against itself on the input scaled by 1 - 2^-20
F32_TOL = {"vit": 1e-5, "resnet": 1e-3}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow_resnet(monkeypatch):
    monkeypatch.setattr(jr, "INPLANES", NARROW)
    monkeypatch.setattr(tr, "INPLANES", NARROW)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _vols(seed, n=B):
    return np.random.default_rng(seed).standard_normal((n, 1, VOL, VOL, VOL)).astype(np.float32)


def _jax_model(arch, dtype="float32"):
    return jmk.build_moco_model(JDataConfig(volume_size=VOL), dtype, arch, moco_dim=DIM, moco_mlp_dim=MLP_DIM,
                                vit_overrides=VIT)


def _port_model(arch, dtype="float32"):
    return tmk.build_moco_model(DataConfig(volume_size=VOL), dtype, arch, moco_dim=DIM, moco_mlp_dim=MLP_DIM,
                                vit_overrides=VIT)


@functools.lru_cache
def _shapes(arch):
    model = _jax_model(arch)
    return jax.eval_shape(functools.partial(model.init, use_predictor=True), {"params": jax.random.PRNGKey(0)},
                          jnp.zeros((B, 1, VOL, VOL, VOL), jnp.float32))


def _seeded_variables(arch, dtype, seed):
    """Numpy values for every leaf of the JAX model's variables: kernels at
    their init scale, scales and variances around 1, the rest small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return rng.standard_normal(leaf.shape) * np.sqrt((2.0 if len(leaf.shape) == 5 else 1.0) / fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return 0.1 * rng.standard_normal(leaf.shape)  # biases, means, tokens

    return jax.tree_util.tree_map_with_path(lambda p, leaf: draw(p, leaf).astype(dtype), _shapes(arch))


def _load(model, variables, dtype=torch.float32):
    if dtype == torch.float64:
        model.double()  # before loading: f32 parameters would round the values
    model.load_state_dict(params_from_jax(variables["params"], PATCH, 1, variables["batch_stats"]), strict=True)
    return model


# ---------------------------------------------------------------- LARS

def test_make_lars_matches_jax_f64(x64):
    """5 updates of the port's LARS against the JAX package's chain: a 2-D
    and a 3-D leaf (decayed, trust ratio), a 1-D leaf (neither), a 2-D leaf
    that starts at zero (the trust ratio's |p| = 0 branch on its first
    update), and one whose gradient is zero on odd steps."""
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "tok": (1, 2, 3), "b": (3,), "zero": (2, 4), "idle": (4, 2)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    params["zero"] = np.zeros(shapes["zero"])
    grads = [{k: (np.zeros(s) if k == "idle" and i % 2 else rng.standard_normal(s)) for k, s in shapes.items()}
             for i in range(5)]
    lr, wd, spe, epochs, warmup = 0.3, 0.05, 2, 3, 1

    tx = jax_make_lars(jax_schedule(lr, 0.0, warmup, epochs, spe), weight_decay=wd)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    @jax.jit
    def update(g, opt_state, jparams):
        updates, opt_state = tx.update(g, opt_state, jparams)
        return optax.apply_updates(jparams, updates), opt_state

    for g in grads:
        jparams, opt_state = update(g, opt_state, jparams)
    want_trace = jax.device_get(opt_state[2].trace)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_lars(warmup_cosine_schedule(lr, 0.0, warmup, epochs, spe), weight_decay=wd)(module)
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    assert opt.count == 5
    for k, p in module.named_parameters():
        assert _rel(p, jparams[k]) <= 1e-12, k
        assert _rel(opt.opt.state[p]["trace"], want_trace[k]) <= 1e-12, k
    assert [g["decay"] for g in opt.opt.param_groups] == [True, False]
    assert {n for n, p in module.named_parameters() if any(p is q for q in opt.opt.param_groups[0]["params"])} \
        == {"w", "tok", "zero", "idle"}


# ---------------------------------------------------------------- models

@pytest.mark.parametrize("arch", ["vit", "resnet"])
def test_moco_models_match_jax_f32(arch, narrow_resnet):
    """Training mode (batch statistics, running statistics updated) and
    eval mode: q = predictor(projector(trunk)), z = projector(trunk), the
    trunk features; the running statistics after one training forward."""
    jmodel = _jax_model(arch)
    variables = _seeded_variables(arch, np.float32, seed=11)
    x = _vols(12)

    def jax_fn(v, x):
        q, mut = jmodel.apply(v, x, train=True, use_predictor=True, mutable=["batch_stats"])
        return (q, mut["batch_stats"], jmodel.apply(v, x, train=False, use_predictor=True),
                jmodel.apply(v, x, train=False), jmodel.apply(v, x, method=jmodel.trunk_features))

    q, stats, q_eval, z_eval, feats = jax.device_get(jax.jit(jax_fn)(variables, x))
    tol = F32_TOL[arch]
    model = _load(_port_model(arch), variables)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        model.eval()
        assert _rel(model(xt, use_predictor=True), q_eval) <= 1e-5
        assert _rel(model(xt), z_eval) <= 1e-5
        assert _rel(model.trunk_features(xt), feats) <= 1e-5
        model.train()
        assert _rel(model(xt, use_predictor=True), q) <= tol
    want = params_from_jax(variables["params"], PATCH, 1, stats)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
        assert _rel(got[k], want[k]) <= tol, k


def test_reference_layout_and_init(narrow_resnet):
    """The state dict under the reference MoCo keys (projector grafted at
    base_encoder.head / .fc, `_build_mlp` indices), every key of the JAX
    tree mapped, and the port's own init reproducible from its seed."""
    vit, resnet = _port_model("vit"), _port_model("resnet")
    keys = set(vit.state_dict())
    assert {"base_encoder.head.0.weight", "base_encoder.head.1.running_var", "base_encoder.head.3.weight",
            "base_encoder.head.6.weight", "base_encoder.head.7.running_mean", "predictor.0.weight",
            "predictor.1.weight", "predictor.3.weight", "predictor.4.running_var",
            "base_encoder.patch_embed.proj.weight", "base_encoder.norm.weight"} <= keys
    assert "base_encoder.head.7.weight" not in keys  # the projector's last BatchNorm is affine-free
    rkeys = set(resnet.state_dict())
    assert {"base_encoder.conv1.weight", "base_encoder.fc.0.weight", "base_encoder.fc.4.running_mean",
            "predictor.3.weight"} <= rkeys and not any(k.startswith("predictor.4") for k in rkeys)
    for model in (vit, resnet):
        a = model.init_weights(torch.Generator().manual_seed(5)).state_dict()
        b = type(model).init_weights(model, torch.Generator().manual_seed(5)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
    w = vit.base_encoder.blocks[0].attn.qkv.weight.detach()
    assert float(w.abs().max()) <= np.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    head = vit.projector[0].weight.detach()
    assert float(head.abs().max()) <= np.sqrt(1.0 / head.shape[1])


# bf16 heads against JAX's bf16 heads with XLA's excess precision off: the
# port reads at most 1.6e-7 on the output and 1.8e-7 on a gradient (the
# order of an f32 sum); the head in f32 reads 4.4e-3 or more on the output,
# with BatchNorm's output rounded to bf16 2.2e-3 or more
BF16_TOL = {"out": 1e-5, "grads": 1e-5}


@pytest.mark.parametrize("head", ["projector", "predictor", "resnet_predictor"])
def test_moco_heads_bf16_match_jax(head):
    """One training-mode forward (batch statistics) and backward of a MoCo
    head in bf16 on f32 features: the output, the input's gradient and each
    parameter's gradient; the control must miss."""
    layers, last_bn = {"projector": (3, True), "predictor": (2, True), "resnet_predictor": (2, False)}[head]
    jhead = jm.MoCoMLP(layers, MLP_DIM, DIM, last_bn=last_bn, dtype=jnp.bfloat16)
    x = np.random.default_rng(21).standard_normal((B * 4, 24)).astype(np.float32)
    variables = jax.jit(jhead.init)({"params": jax.random.PRNGKey(1)}, x)
    weight = np.random.default_rng(22).standard_normal((B * 4, DIM)).astype(np.float32)

    def jax_fn(params, x):
        def loss(p, x):
            y, _ = jhead.apply({**variables, "params": p}, x, mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) * weight), y

        (_, y), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x)
        return y.astype(jnp.float32), gp, gx

    compiled = jax.jit(jax_fn).lower(variables["params"], x).compile({"xla_allow_excess_precision": False})
    y, gp, gx = jax.device_get(compiled(variables["params"], x))
    want_grads = params_from_jax({"trunk": {}, "projector": {}, "predictor": gp}, PATCH)

    def readings(dtype=torch.bfloat16, bn_in_bf16=False):
        port = tm.MoCoMLP(layers, 24, MLP_DIM, DIM, last_bn=last_bn, dtype=dtype)
        sd = params_from_jax({"trunk": {}, "projector": {}, "predictor": variables["params"]}, PATCH, 1,
                             {"predictor": variables.get("batch_stats", {})})
        port.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
        if bn_in_bf16:
            for m in port:
                if isinstance(m, FlaxBatchNorm):
                    m.forward = (lambda f: lambda h: f(h).to(torch.bfloat16))(m.forward)
        xt = torch.from_numpy(x).requires_grad_()
        out = port(xt)
        (out.float() * torch.from_numpy(weight)).sum().backward()
        grads = [_rel(p.grad, want_grads[f"predictor.{n}"]) for n, p in port.named_parameters()]
        return {"out": _rel(out.float(), y), "grads": max(grads + [_rel(xt.grad, gx)])}

    got = readings()
    assert all(got[k] <= BF16_TOL[k] for k in BF16_TOL), got
    for control in ({"dtype": torch.float32}, {"bn_in_bf16": True})[:1 + last_bn]:
        errs = readings(**control)
        assert not all(errs[k] <= BF16_TOL[k] for k in BF16_TOL), (control, errs)


# ---------------------------------------------------------------- loss and trajectory

STEPS, SPE, EPOCHS, WARMUP, LR, WD, MOCO_M = 10, 2, 5, 2, 0.05, 0.01, 0.9
CONTROL_STEPS = 3  # the EMA-late control: lr is 0 at step 0, so it shows from step 2 on


@pytest.fixture(scope="module")
def jax_f64():
    """The JAX package's f64 MoCo-ViT, its LARS and its jitted
    `make_moco_train_step` (temperature 1), compiled once for the loss and
    the trajectory."""
    jmodel = _jax_model("vit", "float64")
    tx = jax_make_lars(jax_schedule(LR, 0.0, WARMUP, EPOCHS, SPE), weight_decay=WD)
    return jmodel, tx, jmk.make_moco_train_step(jmodel)


def _jax_state(tx, base, mom):
    copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731  (the step donates its state)
    return jmk.MoCoState(step=jnp.zeros((), jnp.int32), params=copy(base["params"]),
                         batch_stats=copy(base["batch_stats"]), momentum_params=copy(mom["params"]),
                         momentum_batch_stats=copy(mom["batch_stats"]), opt_state=tx.init(copy(base["params"])),
                         tx=tx)


def test_info_nce_and_moco_loss_match_jax_f64(x64, jax_f64):
    """`info_nce` at two temperatures; `moco_loss` with a momentum encoder
    of other weights: JAX's through its jitted step with m = 1 (the EMA
    then keeps the momentum parameters as they are), its loss and the base
    encoder's running statistics after the two base passes."""
    rng = np.random.default_rng(31)
    q, k = rng.standard_normal((2, 6, DIM))
    for t in (1.0, 0.2):
        want = float(jm.info_nce(jnp.asarray(q), jnp.asarray(k), t))
        got = float(tm.info_nce(torch.from_numpy(q), torch.from_numpy(k), t))
        assert abs(got - want) <= 1e-12 * abs(want), t

    _, tx, jstep = jax_f64
    base = _seeded_variables("vit", np.float64, seed=32)
    mom = _seeded_variables("vit", np.float64, seed=33)
    x1, x2 = _vols(34).astype(np.float64), _vols(35).astype(np.float64)
    jstate, metrics = jstep(_jax_state(tx, base, mom), jnp.asarray(x1), jnp.asarray(x2), jnp.float32(1.0))
    want = float(metrics["loss"])
    model = _load(_port_model("vit", "float64"), base, torch.float64)
    mom_model = _load(_port_model("vit", "float64"), mom, torch.float64)
    got = tm.moco_loss(model, mom_model.base_encoder, torch.from_numpy(x1), torch.from_numpy(x2), 1.0)
    assert abs(float(got.detach()) - want) <= 1e-12 * abs(want)
    want_sd = params_from_jax(base["params"], PATCH, 1, jax.device_get(jstate.batch_stats))
    for key, value in model.state_dict().items():
        assert _rel(value, want_sd[key]) <= 1e-12, key


def _worst(got: dict, want: dict, rtol=1e-9, atol=1e-11):
    """Worst leaf's max |got - want| / (rtol max |want| + atol) over `want`'s
    keys (MoCo's trunk/norm/bias is gradient-free: its f64 noise needs the
    atol, as in tests/test_moco_trajectory.py)."""
    errs = []
    for key, w in want.items():
        w = w.double().numpy()
        g = got[key].detach().double().numpy()
        errs.append((float(np.abs(g - w).max() / (rtol * np.abs(w).max() + atol)), key))
    return max(errs)


def _late_ema_step(model, temperature=1.0):
    """The control: the EMA of the momentum parameters after the optimizer
    step (with the updated base parameters), as the JAX package's step did
    before its round-4 repair."""

    def step(state, x1, x2, m):
        mom = state.momentum_encoder
        stats = tmk._batch_stats(mom)
        kept = [b.clone() for b in stats]
        loss = tm.moco_loss(state.model, mom, x1, x2, temperature)
        for p in state.tx.params:
            p.grad = None
        loss.backward()
        state.tx.step()
        tm.ema_update(list(mom.parameters()), list(state.model.base_encoder.parameters()), m)
        with torch.no_grad():
            torch._foreach_copy_(stats, kept)
        tm.ema_update(stats, tmk._batch_stats(state.model.base_encoder), m)
        return state, {"loss": loss.detach()}

    return step


def test_moco_trajectory_matches_jax_f64(x64, jax_f64):
    jmodel, tx, jstep = jax_f64
    rng = np.random.default_rng(23)
    x1, x2 = rng.standard_normal((2, STEPS, B, 1, VOL, VOL, VOL))
    init = jax.jit(functools.partial(jmodel.init, use_predictor=True))
    variables = init({"params": jax.random.PRNGKey(3)}, jnp.asarray(x1[0]))
    variables = jax.tree.map(lambda v: np.asarray(v, np.float64), variables)
    ms = [jmk.adjust_moco_momentum(i / SPE, MOCO_M, EPOCHS) for i in range(STEPS)]

    def momentum(jstate) -> dict:
        """The momentum encoder, trunk and projector, parameters and
        statistics (JAX's momentum tree also carries an unused predictor
        copy)."""
        jstate = jax.device_get(jstate)
        sd = params_from_jax(jstate.momentum_params, PATCH, 1, jstate.momentum_batch_stats)
        return {k: v for k, v in sd.items() if k.startswith("base_encoder.")}

    jstate = _jax_state(tx, variables, variables)
    want_losses = []
    for i in range(STEPS):
        jstate, metrics = jstep(jstate, jnp.asarray(x1[i]), jnp.asarray(x2[i]), jnp.float32(ms[i]))
        want_losses.append(float(metrics["loss"]))
        if i + 1 == CONTROL_STEPS:
            want_mom_early = momentum(jstate)
    want_mom = momentum(jstate)
    jstate = jax.device_get(jstate)
    want_base = params_from_jax(jstate.params, PATCH, 1, jstate.batch_stats)

    def run(make_step, steps=STEPS):
        model = _load(_port_model("vit", "float64"), variables, torch.float64)
        state = tmk.create_moco_state(model, make_lars(warmup_cosine_schedule(LR, 0.0, WARMUP, EPOCHS, SPE),
                                                       weight_decay=WD))
        step = make_step(model)
        losses = []
        for i in range(steps):
            state, metrics = step(state, torch.from_numpy(x1[i]), torch.from_numpy(x2[i]), ms[i])
            losses.append(float(metrics["loss"]))
        mom = {f"base_encoder.{k}": v for k, v in state.momentum_encoder.state_dict().items()}
        return losses, model.state_dict(), mom

    losses, base, mom = run(tmk.make_moco_train_step)
    for i, (got, want) in enumerate(zip(losses, want_losses)):
        assert abs(got - want) <= 1e-9 * abs(want), (i, losses, want_losses)
    assert set(base) == set(want_base)
    err = _worst(base, want_base)
    assert err[0] < 1, f"base parameters and statistics: {err}"
    assert set(mom) == set(want_mom)
    err = _worst(mom, want_mom)
    assert err[0] < 1, f"momentum encoder: {err}"

    _, _, late = run(_late_ema_step, CONTROL_STEPS)
    err = _worst(late, want_mom_early)
    assert err[0] > 1, f"the EMA one step late went unseen: {err}"
