"""The port's supervised 3D ResNet against the JAX package's, on the CPU.

- `ResNet3D` with the same weights (seeded numpy values of JAX's tree,
  BatchNorm scales, biases and running statistics included, passed to the
  port through `params_from_jax`): in eval mode in f32, logits and features
  within 1e-5 of the largest reference magnitude; in train mode in f64,
  logits and the updated running statistics within 1e-10 relative. Depth 10
  at full width (64-512) and depth 50 (the Bottleneck path) at widen
  factor 1/16, 16^3 volumes, batch 4. Train mode runs in f64 because f32
  batch statistics over a handful of voxels (layer4 holds one voxel a
  volume at 16^3) amplify rounding: the port's f32 forward against its own
  f64 forward reads 1e-2 on ResNet-50's logits there, the JAX package's
  the same, so an f32 comparison could not see a semantic fault.
- The bf16 model's rounding points against JAX's bf16 model compiled with
  XLA's excess precision off, in eval mode at the same sizes: loss within
  2e-5 and logits within 1e-3 (both read equal), features within 1e-5,
  gradients within 2e-3 (median) and 5e-2 (worst), with three controls
  that must miss (`BF16_TOL`).
- A 3-step f64 trajectory through `make_resnet_steps` and
  `make_resnet_tx` against the JAX package's, from JAX's init: losses,
  parameters and BatchNorm buffers within 1e-10 relative.
- `resnet_kfold` end to end against the JAX package's on a synthetic BraTS
  tree (32 volumes of 16^3, 2 folds of 16 training volumes at batch 6, so
  each epoch ends on a partial batch of 4; 2 epochs; f32; the scipy
  augmentation policy in both; ResNet-10 at widen factor 1/4 in both), with
  JAX's init injected into the port: every `log.txt` row's loss within
  1e-4 relative and its AUC, specificity and sensitivity within 1e-6, the
  best ROC of each fold equal, one best `.pth` per fold that loads into
  `ResNet3D`, and `eval_only` reading back each fold's best ROC.
- The CLI on the CPU, and its refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.models import resnet3d as jr
from vit_ae_plus_plus_tpu.pipelines import resnet_kfold as jrk
from vit_ae_plus_plus_tpu.train.state import TrainState as JTrainState
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.cli import run as cli_run
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.models import resnet3d as tr
from vit_ae_plus_plus_torch.models.vit import FlaxBatchNorm
from vit_ae_plus_plus_torch.pipelines import resnet_kfold as trk
from vit_ae_plus_plus_torch.train import create_train_state
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

B, VOL = 4, 16
MODELS = {"depth10": (10, 1.0), "depth50": (50, 1 / 16)}
LOSS_RTOL, METRIC_TOL = 1e-4, 1e-6


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _seeded_variables(model, dtype, seed: int):
    """Numpy values for JAX's variable tree of `model`: convolutions and
    the head at their init scale, BatchNorm scales, biases, means and
    variances spread around their init values."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)}, jnp.zeros((B, 1, VOL, VOL, VOL)))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan = leaf.shape[-2] if len(leaf.shape) == 2 else np.prod(leaf.shape[:-2]) * leaf.shape[-1]
            return (rng.standard_normal(leaf.shape) * np.sqrt((1.0 if len(leaf.shape) == 2 else 2.0) / fan))
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return 0.1 * rng.standard_normal(leaf.shape)  # bias, mean

    return jax.tree_util.tree_map_with_path(lambda p, leaf: draw(p, leaf).astype(dtype), shapes)


def _port_model(depth, wf, variables, dtype="float32"):
    model = tr.generate_model(depth, n_classes=2, widen_factor=wf, dtype=dtype)
    if dtype == "float64":
        model.double()  # before loading: f32 parameters would round the values
    model.load_state_dict(params_from_jax(variables["params"], batch_stats=variables["batch_stats"]), strict=True)
    return model


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet3d_eval_matches_jax_f32(name):
    depth, wf = MODELS[name]
    jm = jr.generate_model(depth, n_classes=2, widen_factor=wf)
    variables = _seeded_variables(jm, np.float32, seed=depth)
    x = np.random.default_rng(1).standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)
    want_logits, want_feats = jax.jit(lambda v, x: (jm.apply(v, x, train=False),
                                                    jm.apply(v, x, train=False, return_features=True)))(variables, x)
    model = _port_model(depth, wf, variables).eval()
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x)), model.forward_features(torch.from_numpy(x))
    assert logits.dtype == feats.dtype == torch.float32
    assert _rel(logits, want_logits) <= 1e-5 and _rel(feats, want_feats) <= 1e-5


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet3d_train_matches_jax_f64(name, x64):
    depth, wf = MODELS[name]
    jm = jr.generate_model(depth, n_classes=2, widen_factor=wf, dtype=jnp.float64)
    variables = _seeded_variables(jm, np.float64, seed=depth + 1)
    x = np.random.default_rng(2).standard_normal((B, 1, VOL, VOL, VOL))
    want_logits, mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(variables, x)
    model = _port_model(depth, wf, variables, "float64").train()
    logits = model(torch.from_numpy(x))
    assert logits.dtype == torch.float64 and _rel(logits.detach(), want_logits) <= 1e-10
    want = params_from_jax(variables["params"], batch_stats=mutated["batch_stats"])
    got = model.state_dict()
    for k in (k for k in want if k.endswith(("running_mean", "running_var"))):
        assert _rel(got[k], want[k]) <= 1e-10, k


# bf16 against JAX's bf16 model with XLA's excess precision off (below):
# each limit sits between the port's reading and the nearest control's, on
# this file's CPU (depth 10 / depth 50 at 16^3): logits and loss 0 / 0
# against 4.5e-3 and 2.8e-4 for a head that adds its bias before rounding;
# features 1.9e-7 / 1.1e-7 against 8.8e-3 / 1.2e-2 for BatchNorm's output
# rounded to bf16; the median gradient 7.0e-5 / 0 and the worst 7.1e-3 /
# 1.2e-3 (a rare bf16 rounding flipped by the order of an f32 sum) against
# 5.1e-2 / 0.37 and 0.39 / 2.1 for that BatchNorm
BF16_TOL = {"loss": 2e-5, "logits": 1e-3, "features": 1e-5, "grads_median": 2e-3, "grads": 5e-2}


def _bf16_readings(model, want: dict, x, y, cw) -> dict:
    """The port's bf16 eval-mode loss, logits, features and every gradient
    against `want`: each one's largest error over its largest magnitude,
    the gradients as their median and worst."""
    xt = torch.from_numpy(x)
    logits = model(xt)
    loss = trk.weighted_ce(logits, torch.from_numpy(y), torch.from_numpy(cw))
    loss.backward()
    with torch.no_grad():
        feats = model.forward_features(xt)
    errs = {"loss": _rel(loss.item(), want["loss"]), "logits": _rel(logits.detach().float(), want["logits"]),
            "features": _rel(feats.float(), want["features"])}
    grads = [_rel(p.grad.float(), want["grads"][n]) for n, p in model.named_parameters()]
    return {**errs, "grads_median": float(np.median(grads)), "grads": max(grads)}


@pytest.mark.parametrize("name", list(MODELS))
def test_resnet3d_bf16_matches_jax(name):
    """The bf16 model's rounding points against the JAX package's: one
    forward and backward through `weighted_ce` (class weights 3, 1) with
    BatchNorm on its running statistics, so that the comparison sees the
    casts and not the ill-conditioning of batch statistics over a few
    voxels (train mode's batch-statistics code is held in f64 above). JAX's
    model is compiled with XLA's `xla_allow_excess_precision` off: with it
    on (the default) XLA drops the bf16 roundings that flax declares, such
    as a convolution's output before BatchNorm, and reads 8e-2 on the
    median gradient, as far as the f32 model does. Three controls must each
    miss a limit: BatchNorm's output rounded to bf16, the head's bias added
    before the rounding (one rounding where flax's Dense makes two), and
    the model in f32."""
    depth, wf = MODELS[name]
    jm = jr.generate_model(depth, n_classes=2, widen_factor=wf, dtype=jnp.bfloat16)
    variables = _seeded_variables(jm, np.float32, seed=depth + 3)
    x = np.random.default_rng(3).standard_normal((B, 1, VOL, VOL, VOL)).astype(np.float32)
    y, cw = np.arange(B) % 2, np.array([3.0, 1.0], np.float32)

    def jax_fn(params, x):
        v = {"params": params, "batch_stats": variables["batch_stats"]}

        def loss_fn(p):
            logits = jm.apply({**v, "params": p}, x, train=False)
            return jrk.weighted_ce(logits, jnp.asarray(y), jnp.asarray(cw)), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, logits.astype(jnp.float32), jm.apply(v, x, train=False, return_features=True), grads

    compiled = jax.jit(jax_fn).lower(variables["params"], x).compile({"xla_allow_excess_precision": False})
    loss, logits, feats, grads = jax.device_get(compiled(variables["params"], x))
    want = {"loss": float(loss), "logits": logits, "features": feats, "grads": params_from_jax(grads)}

    def readings(dtype="bfloat16", bn_in_bf16=False, one_rounding=False) -> dict:
        model = _port_model(depth, wf, variables, dtype).eval()
        if bn_in_bf16:
            for m in model.modules():
                if isinstance(m, FlaxBatchNorm):
                    m.forward = (lambda f: lambda h: f(h).to(h.dtype))(m.forward)
        if one_rounding:
            model.forward = lambda h: F.linear(model.forward_features(h).to(model.dtype),
                                               model.fc.weight.to(model.dtype), model.fc.bias.to(model.dtype))
        return _bf16_readings(model, want, x, y, cw)

    def within(errs: dict) -> bool:
        return all(errs[k] <= BF16_TOL[k] for k in BF16_TOL)

    got = readings()
    assert within(got), got
    for control in ({"bn_in_bf16": True}, {"one_rounding": True}, {"dtype": "float32"}):
        errs = readings(**control)
        assert not within(errs), (control, errs)


def test_resnet_trajectory_matches_jax_f64(x64):
    """3 steps of the port's `make_resnet_steps` / `make_resnet_tx` against
    the JAX package's from JAX's init (warmup ends mid-run)."""
    steps, spe, epochs, warmup, lr, min_lr, cw = 3, 2, 5, 1, 1e-3, 1e-5, (3.0, 1.0)
    jm = jr.generate_model(10, n_classes=2, widen_factor=0.25, dtype=jnp.float64)
    variables = jax.jit(jm.init)({"params": jax.random.PRNGKey(5)}, jnp.zeros((B, 1, VOL, VOL, VOL)))
    variables = jax.tree.map(lambda v: np.asarray(v, np.float64), variables)
    rng = np.random.default_rng(11)
    xs = rng.standard_normal((steps, B, 1, VOL, VOL, VOL))
    ys = np.stack([rng.permutation(np.arange(B) % 2) for _ in range(steps)])

    tx = jrk.make_resnet_tx(lr, epochs, spe, min_lr=min_lr, warmup_epochs=warmup)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                        batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]), tx=tx)
    j_step, _ = jrk.make_resnet_steps(jm, np.asarray(cw))
    want_losses = []
    for i in range(steps):
        state, m = j_step(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]), jax.random.PRNGKey(0))
        want_losses.append(float(m["loss"]))
    want = params_from_jax(jax.device_get(state.params), batch_stats=jax.device_get(state.batch_stats))

    model = _port_model(10, 0.25, variables, "float64")
    t_state = create_train_state(model, trk.make_resnet_tx(lr, epochs, spe, min_lr=min_lr, warmup_epochs=warmup))
    t_step, _ = trk.make_resnet_steps(model, cw)
    for i in range(steps):
        t_state, m = t_step(t_state, torch.from_numpy(xs[i]), ys[i])
        assert abs(float(m["loss"]) - want_losses[i]) <= 1e-10 * abs(want_losses[i]), (i, float(m["loss"]))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-10, k


# ---------------------------------------------------------------- resnet_kfold

N_VOLS, FOLDS, EPOCHS, BATCH, WF = 32, 2, 2, 6, 0.25


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    labels = np.array([0, 1] * (N_VOLS // 2))
    vols = rng.standard_normal((N_VOLS, VOL, VOL, VOL, 1)).astype(np.float32) + 0.3 * labels[:, None, None, None, None]
    np.save(root / "x_whole_ssl.npy", vols.astype(np.float32))
    np.save(root / "y_whole_ssl.npy", labels)
    return str(root)


def _configs(data_dir):
    dkw = dict(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1, use_z_score=True)
    tkw = dict(epochs=EPOCHS, batch_size=BATCH, compute_dtype="float32", seed=3)
    return (JDataConfig(**dkw), JTrainConfig(**tkw)), (DataConfig(**dkw), TrainConfig(**tkw))


def _log(work):
    with open(os.path.join(work, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _check_row(got, want, where):
    assert set(got) == set(want), where
    for k, w in want.items():
        if k.endswith("loss"):
            assert abs(got[k] - w) <= LOSS_RTOL * abs(w), (where, k, got[k], w)
        elif isinstance(w, float):
            assert abs(got[k] - w) <= METRIC_TOL, (where, k, got[k], w)
        else:
            assert got[k] == w, (where, k)


def test_resnet_kfold_matches_jax(data_dir, tmp_path, monkeypatch):
    (jd, jtc), (td, tc) = _configs(data_dir)
    inits = []

    def j_generate_model(depth, n_classes=2, **kw):
        model = jr.generate_model(depth, n_classes=n_classes, widen_factor=WF, **kw)
        init = jax.jit(model.init)

        class Recorded:  # JAX's init, compiled once and recorded
            def __getattr__(self, name):
                return getattr(model, name)

            def init(self, *args):
                inits.append(jax.tree.map(np.asarray, init(*args)))
                return inits[-1]

        return Recorded()

    monkeypatch.setattr(jrk, "generate_model", j_generate_model)
    monkeypatch.setattr(jrk, "default_ssl_transforms", lambda: jt.default_ssl_transforms(native="never"))
    j_work = str(tmp_path / "jax")
    want = jrk.resnet_kfold(jd, jtc, j_work, n_splits=FOLDS)
    want_eval = jrk.resnet_kfold(jd, jtc, j_work, n_splits=FOLDS, eval_only=True)
    assert len(inits) == 2 * FOLDS

    def t_generate_model(depth, **kw):
        model = tr.generate_model(depth, widen_factor=WF, **kw)
        variables = inits[0]  # the same PRNGKey(seed) draw starts every fold
        model.init_weights = lambda _generator: model.load_state_dict(
            params_from_jax(variables["params"], batch_stats=variables["batch_stats"]), strict=True)
        return model

    monkeypatch.setattr(trk, "generate_model", t_generate_model)
    monkeypatch.setattr(trk, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never"))
    t_work = str(tmp_path / "port")
    got = trk.resnet_kfold(td, tc, t_work, n_splits=FOLDS, device="cpu")
    rows, want_rows = _log(t_work), _log(j_work)
    assert [(r["fold"], r["epoch"]) for r in rows] == [(k, e) for k in range(FOLDS) for e in range(EPOCHS)]
    for i, (g, w) in enumerate(zip(rows, want_rows)):
        _check_row(g, w, f"row {i}")
    assert sorted(got) == sorted(want) == list(range(FOLDS))
    for k in range(FOLDS):
        assert abs(got[k]["best_roc"] - want[k]["best_roc"]) <= METRIC_TOL
        assert os.path.isdir(os.path.join(j_work, "checkpoints", f"best_ft_model_split{k}"))
        sd = torch.load(trk.best_model_path(t_work, k), map_location="cpu", weights_only=True)
        tr.generate_model(10, widen_factor=WF).load_state_dict(sd, strict=True)
    for k in range(FOLDS):
        assert np.array_equal(np.load(os.path.join(t_work, "k_fold", "indices_file", f"test_{k}.npy")),
                              np.load(os.path.join(j_work, "k_fold", "indices_file", f"test_{k}.npy")))

    got_eval = trk.resnet_kfold(td, tc, t_work, n_splits=FOLDS, eval_only=True, device="cpu")
    assert len(_log(t_work)) == FOLDS * EPOCHS  # eval_only adds no row
    for k in range(FOLDS):
        assert got_eval[k]["roc_auc_score"] == got[k]["best_roc"]
        _check_row(got_eval[k], want_eval[k], f"eval_only fold {k}")


def test_resnet_kfold_cli_and_refusals(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(trk, "default_ssl_transforms", lambda: None)
    common = ["--data-path", data_dir, "--volume-size", str(VOL), "--batch-size", str(BATCH), "--epochs", "1",
              "--n-splits", "2", "--compute-dtype", "float32", "--device", "cpu"]
    work = str(tmp_path / "cli")
    monkeypatch.setattr(tr, "INPLANES", (8, 16, 32, 64))  # a narrow ResNet-10: the CLI's path, not its width
    assert cli_main(["resnet-kfold", *common, "--work-dir", work]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["0", "1"] and all(0.0 <= r["best_roc"] <= 1.0 for r in out.values())
    assert cli_main(["resnet-kfold", *common, "--work-dir", work, "--eval-only"]) == 0
    out_eval = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {k: r["roc_auc_score"] for k, r in out_eval.items()} == {k: r["best_roc"] for k, r in out.items()}
    # refused before any data is read, on any device
    missing = ["--data-path", str(tmp_path / "none")]
    assert cli_run(["resnet-kfold", *missing, "--work-dir", str(tmp_path / "w"), "--n-devices", "2"]) == 2
    assert "n_devices > 1" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_run(["resnet-kfold", *missing, "--work-dir", str(tmp_path / "w")]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on, to the data
        trk.resnet_kfold(DataConfig(base_path=str(tmp_path / "none")), TrainConfig(), str(tmp_path / "w"),
                         device="cpu")


def test_port_init_draws_jaxs_distributions():
    """The port's own init: each convolution's weights a truncated normal of
    std sqrt(2 / fan_out), the head's of std sqrt(1 / fan_in) with zero
    bias, BatchNorm at its identity, reproducible from the seed."""
    model = tr.generate_model(10, widen_factor=0.5)
    model.init_weights(torch.Generator().manual_seed(7))
    again = tr.generate_model(10, widen_factor=0.5)
    again.init_weights(torch.Generator().manual_seed(7))
    for (name, p), q in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
    w = model.layer1[0].conv1.weight.detach()
    std = np.sqrt(2.0 / (w.shape[0] * 27))
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert abs(float(w.std()) - std) <= 0.05 * std
    assert float(model.fc.bias.abs().max()) == 0.0 and float(model.bn1.running_var.min()) == 1.0
