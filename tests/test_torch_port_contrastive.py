"""The port's `contrastive-train` against the JAX package's, on the CPU.

- `VisionTransformer3DContrastive` (a ViT of depth 2, width 24, 16^3
  volumes at patch 4; the JAX module's seeded numpy variables through
  `params_from_jax`), with and without the projector, in training mode:
  p1, p2, z1, z2 and the heads' running statistics after the forward,
  each within `MODEL_TOL` of its largest reference magnitude (f64 1e-10,
  f32 1e-5: only the summation order differs).
- The unmasked AdamW (`AdamW(..., decay_mask=decay_everything)`)
  against `optax.adamw(schedule, b1=0.9, b2=0.95, weight_decay=...)` in
  f64, 5 updates under a warmup-cosine schedule over 2-D, 3-D and 1-D
  leaves: parameters within 1e-12 of their largest magnitude; the masked
  AdamW (biases and scales not decayed) must miss.
- 5 f64 steps of `make_contrastive_step` against the JAX package's jitted
  step from the same weights and views, with and without the projector:
  losses, parameters and statistics after the steps within 1e-10 (atol:
  the trunk's fc_norm bias reaches the loss only through the heads'
  BatchNorm, which removes it, so its gradient is f64 noise that AdamW
  scales by lr / eps, about 1e-11 after 5 steps); the masked AdamW's
  trajectory must miss.
- `contrastive_train` end to end on a synthetic BraTS tree (10 volumes of
  16^3 at batch 4: 2 steps an epoch, 2 epochs, the projector on, the scipy
  augmentation policy in both), f64, JAX's initial weights injected, a
  warmup epoch and `accum_iter` 2 (which scales the learning rate only):
  every `log.txt` row's loss within 1e-10 of JAX's, the min loss, and the
  min-loss `.pth` against the weights JAX saved, within 1e-10 of their
  magnitude or of 1 (fc_norm's bias starts at 0 and stays f64 noise, as
  above); the `.pth` loads into the port's model.
- The CLI on the CPU (`--use-proj`), its refusal of a batch that
  `--n-devices` does not split, and the `no CUDA device` path.
"""

import contextlib
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.configs import ViTConfig as JViTConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3DContrastive as JaxContrastive
from vit_ae_plus_plus_tpu.pipelines import contrastive as jc
from vit_ae_plus_plus_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.cli import run as cli_run
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig, ViTConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.models import VisionTransformer3DContrastive
from vit_ae_plus_plus_torch.pipelines import contrastive as tc
from vit_ae_plus_plus_torch.train import warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax
from vit_ae_plus_plus_torch.train.optim import AdamW, decay_everything

from test_torch_port_moco_ddp import seeded, x64

B, VOL, PATCH, N_VOLS = 4, 16, 4, 10
TINY = dict(embed_dim=24, depth=2, num_heads=3)
CFG = dict(volume_size=VOL, patch_size=PATCH, in_chans=1, num_classes=2, global_pool=True, **TINY)
MODEL_TOL = {"float64": 1e-10, "float32": 1e-5}
LR, WD, WARMUP, EPOCHS, SPE, STEPS = 1e-3, 0.05, 1, 3, 2, 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Module-wide, so that it holds in the module-scoped fixtures too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f64():
    with x64():
        yield


def _jax_model(dtype, use_proj):
    return JaxContrastive(JViTConfig(**CFG, dtype=dtype), use_proj=use_proj)


@functools.lru_cache
def _shapes(use_proj):
    x = jnp.zeros((2, 1, VOL, VOL, VOL), jnp.float32)
    return jax.eval_shape(_jax_model("float32", use_proj).init, {"params": jax.random.PRNGKey(0)}, x, x)


def _variables(use_proj, dtype, seed=61):
    return jax.tree.map(lambda v: np.asarray(v, dtype), seeded(_shapes(use_proj), seed))


def _port(variables, dtype, use_proj):
    model = VisionTransformer3DContrastive(ViTConfig(**CFG, dtype=dtype), use_proj=use_proj)
    if dtype == "float64":
        model.double()  # before loading: f32 parameters would round the values
    model.load_state_dict(params_from_jax(variables["params"], PATCH, 1, variables["batch_stats"]), strict=True)
    return model


def _vols(seed, shape=(B,)):
    return np.random.default_rng(seed).standard_normal((*shape, 1, VOL, VOL, VOL))


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _stats(params, batch_stats):
    sd = params_from_jax(params, PATCH, 1, batch_stats)
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("use_proj", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_contrastive_model_matches_jax(dtype, use_proj):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    variables = _variables(use_proj, np_dtype)
    x1, x2 = (_vols(seed).astype(np_dtype) for seed in (62, 63))
    with x64() if dtype == "float64" else contextlib.nullcontext():
        (want, mutated) = _jax_model(dtype, use_proj).apply(variables, jnp.asarray(x1), jnp.asarray(x2), train=True,
                                                            mutable=["batch_stats"])
        want = [np.asarray(w) for w in want]
        want_stats = _stats(variables["params"], jax.device_get(mutated["batch_stats"]))
    model = _port(variables, dtype, use_proj).train()
    got = model(torch.from_numpy(x1), torch.from_numpy(x2))
    assert not got[2].requires_grad and not got[3].requires_grad and got[0].requires_grad
    tol = MODEL_TOL[dtype]
    for name, g, w in zip(("p1", "p2", "z1", "z2"), got, want):
        assert g.shape == w.shape == (B, TINY["embed_dim"]), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    buffers = dict(model.named_buffers())
    assert set(buffers) == set(want_stats) and any("projector" in n for n in buffers) == use_proj
    for n, w in want_stats.items():
        assert _rel(buffers[n], w) <= tol, (n, _rel(buffers[n], w))


# ---------------------------------------------------------------- the optimizer

def _adamw_run(decay_mask, leaves, grads):
    module = torch.nn.Module()
    for k, v in leaves.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = AdamW(module, warmup_cosine_schedule(LR, 0.0, WARMUP, EPOCHS, SPE), WD, decay_mask=decay_mask)
    for g in grads:
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return dict(module.named_parameters())


def test_unmasked_adamw_matches_optax_f64(f64):
    from vit_ae_plus_plus_torch.train.optim import weight_decay_mask

    rng = np.random.default_rng(64)
    shapes = {"w": (5, 3), "tok": (1, 2, 3), "bias": (3,), "scale": (4,)}
    leaves = {k: rng.standard_normal(s) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s) for k, s in shapes.items()} for _ in range(STEPS)]
    tx = optax.adamw(jax_schedule(LR, 0.0, WARMUP, EPOCHS, SPE), b1=0.9, b2=0.95, weight_decay=WD)
    params = jax.tree.map(jnp.asarray, leaves)
    state = tx.init(params)

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for g in grads:
        params, state = update(g, state, params)
    got = _adamw_run(decay_everything, leaves, grads)
    for k in shapes:
        assert _rel(got[k], params[k]) <= 1e-12, k
    masked = _adamw_run(weight_decay_mask, leaves, grads)
    assert min(_rel(masked[k], params[k]) for k in ("bias", "scale")) > 1e-6


# ---------------------------------------------------------------- the step

def _worst(got: dict, want: dict) -> tuple:
    """The worst leaf's max |got - want| and its name."""
    return max((float(np.abs(got[k].detach().double().numpy() - np.asarray(w)).max()), k) for k, w in want.items())


@pytest.mark.parametrize("use_proj", [False, True])
def test_contrastive_trajectory_matches_jax_f64(use_proj, f64):
    variables = _variables(use_proj, np.float64, seed=65)
    orig, aug = _vols(66, (STEPS, B)), _vols(67, (STEPS, B))
    tx = optax.adamw(jax_schedule(LR, 0.0, WARMUP, EPOCHS, SPE), b1=0.9, b2=0.95, weight_decay=WD)
    params, bs = (jax.tree.map(jnp.array, variables[k]) for k in ("params", "batch_stats"))
    jstate = jc.ContrastiveState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bs,
                                 opt_state=tx.init(params), tx=tx)
    jstep = jc.make_contrastive_step(_jax_model("float64", use_proj))
    want_losses = []
    for i in range(STEPS):
        jstate, metrics = jstep(jstate, jnp.asarray(orig[i]), jnp.asarray(aug[i]))
        want_losses.append(float(metrics["loss"]))
    jstate = jax.device_get(jstate)
    want = {k: v.numpy() for k, v in params_from_jax(jstate.params, PATCH, 1, jstate.batch_stats).items()}

    def run(decay_mask):
        model = _port(variables, "float64", use_proj)
        state = tc.ContrastiveState(model=model, tx=AdamW(model, warmup_cosine_schedule(LR, 0.0, WARMUP, EPOCHS, SPE),
                                                          WD, decay_mask=decay_mask))
        step = tc.make_contrastive_step(model)
        losses = []
        for i in range(STEPS):
            state, metrics = step(state, torch.from_numpy(orig[i]), torch.from_numpy(aug[i]))
            losses.append(float(metrics["loss"]))
        assert state.step == STEPS
        return losses, model.state_dict()

    losses, sd = run(decay_everything)
    for i, (got, w) in enumerate(zip(losses, want_losses)):
        assert abs(got - w) <= 1e-10, (i, losses, want_losses)
    assert set(sd) == set(want)
    err = _worst(sd, want)
    assert err[0] <= 1e-10, err

    from vit_ae_plus_plus_torch.train.optim import weight_decay_mask

    _, masked = run(weight_decay_mask)
    assert _worst(masked, want)[0] > 1e-10


# ---------------------------------------------------------------- the pipeline

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    labels = np.arange(N_VOLS) % 2
    vols = rng.standard_normal((N_VOLS, VOL, VOL, VOL, 1)) + 0.3 * labels[:, None, None, None, None]
    np.save(root / "x_whole_ssl.npy", vols.astype(np.float32))
    np.save(root / "y_whole_ssl.npy", labels)
    return str(root)


def _configs(data_dir):
    dkw = dict(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1, use_z_score=True)
    tkw = dict(epochs=2, batch_size=B, patch_size=PATCH, compute_dtype="float64", seed=5, blr=0.05,
               warmup_epochs=1, accum_iter=2)
    return (JDataConfig(**dkw), JTrainConfig(**tkw)), (DataConfig(**dkw), TrainConfig(**tkw))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_contrastive_train_matches_jax(data_dir, tmp_path, monkeypatch, f64):
    (jd, jtc), (td, ttc) = _configs(data_dir)
    inits, saved = [], {}

    def recording(cfg, use_proj=False):
        model = JaxContrastive(cfg, use_proj=use_proj)

        class Recorded:
            def __getattr__(self, name):
                return getattr(model, name)

            def init(self, rngs, *xs):
                inits.append(jax.tree.map(lambda v: np.asarray(v, np.float64), jax.jit(model.init)(rngs, *xs)))
                return inits[-1]

        return Recorded()

    monkeypatch.setattr(jc, "VisionTransformer3DContrastive", recording)
    monkeypatch.setattr(jc, "save_params", lambda path, tree: saved.__setitem__(path, jax.device_get(tree)))
    monkeypatch.setattr(jc, "default_ssl_transforms", lambda: jt.default_ssl_transforms(native="never"))
    want = jc.contrastive_train(jd, jtc, str(tmp_path / "jax"), use_proj=True, vit_overrides=TINY)

    class Injected(VisionTransformer3DContrastive):
        def init_weights(self, generator):
            self.double()
            self.load_state_dict(params_from_jax(inits[0]["params"], PATCH, 1, inits[0]["batch_stats"]), strict=True)
            return self

    monkeypatch.setattr(tc, "VisionTransformer3DContrastive", Injected)
    monkeypatch.setattr(tc, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never"))
    got = tc.contrastive_train(td, ttc, str(tmp_path / "port"), use_proj=True, vit_overrides=TINY, device="cpu")

    rows, want_rows = _rows(tmp_path / "port" / "log.txt"), _rows(tmp_path / "jax" / "log.txt")
    assert [r["epoch"] for r in rows] == [w["epoch"] for w in want_rows] == [0, 1]
    for r, w in zip(rows, want_rows):
        assert set(r) == set(w) == {"train_loss", "epoch"}
        assert abs(r["train_loss"] - w["train_loss"]) <= 1e-10, (rows, want_rows)
    assert abs(got["min_loss"] - want["min_loss"]) <= 1e-10
    assert got["checkpoint"] == str(tmp_path / "port" / "checkpoints" / "checkpoint-min_loss.pth")
    sd = torch.load(got["checkpoint"], map_location="cpu", weights_only=True)
    jsaved = saved[want["checkpoint"]]
    want_sd = params_from_jax(jsaved["params"], PATCH, 1, jsaved["batch_stats"])
    assert set(sd) == set(want_sd)
    for k, w in want_sd.items():
        assert float((sd[k] - w).abs().max()) <= 1e-10 * max(float(w.abs().max()), 1.0), k
    model = VisionTransformer3DContrastive(ViTConfig(**CFG, dtype="float64"), use_proj=True).double()
    model.load_state_dict(sd, strict=True)


def test_contrastive_cli_and_refusals(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tc, "default_ssl_transforms", lambda: None)
    monkeypatch.setattr(tc, "ViTConfig", functools.partial(ViTConfig, **TINY))
    work = tmp_path / "cli"
    common = ["--data-path", data_dir, "--volume-size", str(VOL), "--patch-size", str(PATCH), "--batch-size", str(B),
              "--compute-dtype", "float32", "--device", "cpu"]
    assert cli_main(["contrastive-train", *common, "--work-dir", str(work), "--epochs", "2", "--use-proj"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["checkpoint", "min_loss"] and np.isfinite(out["min_loss"])
    rows = _rows(work / "log.txt")
    assert [r["epoch"] for r in rows] == [0, 1] and out["min_loss"] == min(r["train_loss"] for r in rows)
    model = VisionTransformer3DContrastive(ViTConfig(**CFG), use_proj=True)
    model.load_state_dict(torch.load(out["checkpoint"], map_location="cpu", weights_only=True), strict=True)
    assert os.path.basename(out["checkpoint"]) == "checkpoint-min_loss.pth"
    # refused before any data is read
    missing = ["--data-path", str(tmp_path / "none"), "--work-dir", str(tmp_path / "w")]
    assert cli_run(["contrastive-train", *missing, "--batch-size", "4", "--n-devices", "3", "--device", "cpu"]) == 2
    assert "does not split into 3 equal shards" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_run(["contrastive-train", *missing]) == 2
    assert "no CUDA device" in capsys.readouterr().err
