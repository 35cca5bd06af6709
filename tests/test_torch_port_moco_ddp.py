"""Data parallelism of the port's MoCo and contrastive training, on the CPU.

In this process:
- `info_nce` with this rank's queries against the gathered keys, labels
  offset by d * b: the ranks' local losses of a global batch of 8 split
  into 2 and 4 shards average to the JAX package's `info_nce` of the whole
  batch, in f64 within 1e-12; the control, each shard against its own
  keys with arange labels, misses.
- `moco-kfold` and `contrastive-train` with `--n-devices 2` reach
  `launch_ranks` with the argv they were given (`run_ranks` patched); the
  pipelines refuse a process that sits on another 'data' axis than
  `n_devices` asks for, before any data is read.

The helpers below the line run in the one world of 8 gloo ranks of
tests/test_torch_port_ring_flash.py (rank side) and in its pytest process
(the JAX side), which holds them to each other there:
- the MoCo step on (2, 1) and (4, 1) meshes, both trunks, f64, each rank
  on its rows of a global batch of 8, against JAX `make_moco_train_step(
  ..., mesh=make_mesh(data=D))` on the same weights (a momentum encoder of
  other weights, m = 0.99): the loss, the gradients (read out of JAX's
  jitted mesh step by an optimizer that keeps them as its state) and every
  running statistic of both encoders after the step, `MOCO_TOL` (1e-9;
  the ResNet trunk is f32 in both packages: see there); two
  controls that must miss: the local-keys step (`data_coords` patched to
  one rank: each rank's queries against its own keys) and the
  local-moments step (`models.vit.psum` patched out);
- the contrastive step on (2, 1) against JAX `make_contrastive_step(...,
  mesh=...)`, with a local-moments control;
- `moco_kfold` on 2 ranks, then resumed, against one process's run.

JAX is imported inside the functions that run it: the ranks import this
module by name and need none of it.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.models import moco as tm
from vit_ae_plus_plus_torch.parallel import set_mesh
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

MOCO_B, VOL, PATCH, DIM, MLP_DIM = 8, 16, 4, 8, 16
VIT = dict(patch_size=PATCH, embed_dim=24, depth=2, num_heads=3)
NARROW = (16, 32, 64, 128)  # ResNet-10's stage widths at a quarter
MOCO = dict(moco_dim=DIM, moco_mlp_dim=MLP_DIM, vit_overrides=VIT)
MOCO_M, MOCO_LR = 0.99, 0.05
CONTR_CFG = dict(volume_size=VOL, patch_size=PATCH, in_chans=1, embed_dim=24, depth=2, num_heads=3, num_classes=2,
                 global_pool=True, dtype="float64")
CONTR_LR = 1e-3
# A reading over its limit: each limit the kind's relative limit times the
# reference's largest magnitude, plus `atol` times the largest over all the
# leaves of the kind. The ViT MoCo and the contrastive model in f64 on both
# sides: 1e-9 (the trunk's last LayerNorm bias feeds a BatchNorm, which
# removes it: its gradient is f64 noise of the others' size, hence the
# atol). The ResNet trunk is f32 in both packages under any compute dtype
# (the JAX package's ResNet3D computes in f32): the port's one-process step
# reads loss 4.1e-7, gradients 3.2e-5 and statistics 1.3e-6 against JAX's,
# and train-mode BatchNorm over a few voxels carries the convolutions'
# summation order that far; its limits are about five times those.
MOCO_TOL = {"vit": dict(loss=1e-9, grads=1e-9, stats=1e-9, atol=1e-12),
            "resnet": dict(loss=2e-6, grads=2e-4, stats=1e-5, atol=1e-12)}

@contextlib.contextmanager
def x64():
    """JAX in f64 inside the block, in this thread only (the references of
    tests/test_torch_port_ring_flash.py run in threads beside each other)."""
    import jax

    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ in this process

@pytest.mark.parametrize("data", [2, 4])
def test_info_nce_of_the_ranks_shards_is_the_global_batch_s(data):
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.models import moco as jm

    rng = np.random.default_rng(40 + data)
    q, k = rng.standard_normal((2, MOCO_B, DIM))
    with x64():
        want = float(jm.info_nce(jnp.asarray(q), jnp.asarray(k), 0.2))
    b = MOCO_B // data
    shards = [tm.info_nce(torch.from_numpy(q[r * b:(r + 1) * b]), torch.from_numpy(k), 0.2, r * b)
              for r in range(data)]
    assert abs(float(torch.stack(shards).mean()) - want) <= 1e-12 * abs(want)
    local = [tm.info_nce(torch.from_numpy(q[r * b:(r + 1) * b]), torch.from_numpy(k[r * b:(r + 1) * b]), 0.2)
             for r in range(data)]
    assert abs(float(torch.stack(local).mean()) - want) > 1e-3 * abs(want)


@pytest.mark.parametrize("cmd", ["moco-kfold", "contrastive-train"])
def test_n_devices_launches_the_ranks(cmd, tmp_path, monkeypatch):
    """The command on 2 gloo ranks with `--device cpu` (NCCL on `cuda`
    otherwise), each rank's argv the command's, rank 0's result printed."""
    seen = {}

    def fake(fn, n, args, *, store_dir, timeout, backend):
        seen.update(fn=fn, n=n, argv=args[0], store_dir=store_dir, backend=backend)
        return [{"rank": 0}, {"rank": 1}]

    monkeypatch.setattr("vit_ae_plus_plus_torch.parallel.run_ranks", fake)
    argv = [cmd, "--data-path", str(tmp_path / "none"), "--work-dir", str(tmp_path / "w"), "--batch-size", "4",
            "--n-devices", "2", "--device", "cpu"]
    assert cli.main(argv) == 0
    assert seen == {"fn": cli._rank_command, "n": 2, "argv": argv, "store_dir": str(tmp_path / "w" / ".ranks"),
                    "backend": "gloo"}


@pytest.mark.parametrize("which", ["moco", "contrastive"])
def test_pipelines_refuse_another_data_axis_before_reading(which, tmp_path):
    """`n_devices=2` in a process that sits on no data mesh raises before
    the (missing) data is read."""
    from vit_ae_plus_plus_torch.pipelines.contrastive import contrastive_train
    from vit_ae_plus_plus_torch.pipelines.moco_kfold import moco_kfold

    data_cfg = DataConfig(base_path=str(tmp_path / "none"), volume_size=VOL)
    train_cfg = TrainConfig(batch_size=4, compute_dtype="float32")
    run = moco_kfold if which == "moco" else contrastive_train
    with pytest.raises(ValueError, match="n_devices=2 trains on 2 ranks"):
        run(data_cfg, train_cfg, str(tmp_path / "w"), n_devices=2, device="cpu")


# ------------------------------- the ranks' side of the 8-rank world, and JAX's

@contextlib.contextmanager
def narrow(arch, in_jax=False):
    """The ResNet at a quarter width: the port's, or (`in_jax`) the JAX
    package's, which reads it when it traces (the ranks import no JAX)."""
    from unittest import mock

    if arch != "resnet":
        yield
        return
    if in_jax:
        from vit_ae_plus_plus_tpu.models import resnet3d as module
    else:
        from vit_ae_plus_plus_torch.models import resnet3d as module
    with mock.patch.object(module, "INPLANES", NARROW):
        yield


def moco_views():
    rng = np.random.default_rng(51)
    return rng.standard_normal((2, MOCO_B, 1, VOL, VOL, VOL))


def seeded(shapes, seed):
    """f64 numpy values for the leaves of `shapes` (a `jax.eval_shape` of an
    init): kernels at their init scale, scales and variances in [0.5, 1.5],
    the rest small."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return rng.standard_normal(leaf.shape) * np.sqrt((2.0 if len(leaf.shape) == 5 else 1.0) / fan_in)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape)
        return 0.1 * rng.standard_normal(leaf.shape)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_moco_model(arch, vit=None):
    """The JAX package's MoCo model of `arch`; the ViT trunk `VIT`, or
    `vit` (its attention 'xla' where the port's is 'plain')."""
    from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
    from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk

    overrides = VIT if vit is None else {**vit, "attn_impl": "xla"} if vit.get("attn_impl") == "plain" else vit
    return jmk.build_moco_model(JDataConfig(volume_size=VOL), "float64", arch, **{**MOCO, "vit_overrides": overrides})


def jax_moco_weights(arch, vit=None):
    """The base model's and the momentum encoder's variables (f64 numpy) of
    the JAX package's MoCo model of `arch` (`_jax_moco_model`)."""
    import functools

    import jax
    import jax.numpy as jnp

    with narrow(arch, in_jax=True), x64():
        model = _jax_moco_model(arch, vit)
        shapes = jax.eval_shape(functools.partial(model.init, use_predictor=True), {"params": jax.random.PRNGKey(0)},
                                jnp.zeros((2, 1, VOL, VOL, VOL)))
    return {"base": seeded(shapes, 52), "momentum": seeded(shapes, 53)}


def _keeps_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradients it is given as its state: the gradients of a
    jitted step, read from the state it returns."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads))


def jax_ddp_moco(arch, weights, meshes=((2, 1), (4, 1))):
    """JAX `make_moco_train_step` on each (data, model) mesh of `meshes`
    over the global batch -> {(D, M): (loss, gradients as a state dict, the
    base model's and the momentum encoder's running statistics after the
    step)}."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk

    x1, x2 = moco_views()
    base, mom = weights["base"], weights["momentum"]
    out = {}
    with narrow(arch, in_jax=True), x64():
        model = _jax_moco_model(arch)
        tx = _keeps_grads()
        for data, model_axis in meshes:
            copy = lambda tree: jax.tree.map(jnp.array, tree)  # noqa: E731  (the step donates its state)
            state = jmk.MoCoState(step=jnp.zeros((), jnp.int32), params=copy(base["params"]),
                                  batch_stats=copy(base["batch_stats"]), momentum_params=copy(mom["params"]),
                                  momentum_batch_stats=copy(mom["batch_stats"]), opt_state=tx.init(base["params"]),
                                  tx=tx)
            mesh = jax_mesh(data=data, model=model_axis, devices=jax.devices()[:data * model_axis])
            step = jmk.make_moco_train_step(model, mesh=mesh)
            new, metrics = step(state, jnp.asarray(x1), jnp.asarray(x2), jnp.float32(MOCO_M))
            new = jax.device_get(new)
            grads = params_from_jax(jax.tree.map(np.asarray, new.opt_state), PATCH, 1)
            stats = params_from_jax(new.params, PATCH, 1, new.batch_stats)
            mom_stats = params_from_jax(new.momentum_params, PATCH, 1, new.momentum_batch_stats)
            stats = {k: v.numpy() for k, v in stats.items() if k.endswith(("running_mean", "running_var"))}
            stats.update({f"momentum.{k}": v.numpy() for k, v in mom_stats.items()
                          if k.startswith("base_encoder.") and k.endswith(("running_mean", "running_var"))})
            out[data, model_axis] = (float(metrics["loss"]), {k: v.numpy() for k, v in grads.items()}, stats)
    return out


def _port_moco(arch, variables, vit=None):
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    model = tmk.build_moco_model(DataConfig(volume_size=VOL), "float64", arch,
                                 **{**MOCO, "vit_overrides": vit or VIT}).double()
    model.load_state_dict(params_from_jax(variables["params"], PATCH, 1, variables["batch_stats"]), strict=True)
    return model


def _rows(mesh, t):
    b = t.shape[0] // mesh.size("data")
    return t[mesh.coords["data"] * b:(mesh.coords["data"] + 1) * b]


def ddp_control(control):
    """The controls: 'local_keys', each rank's queries against its own keys
    (the loss reads one rank on the 'data' axis); 'local_moments', every
    BatchNorm on this rank's rows (the group's sum of its moments left
    out)."""
    from unittest import mock

    from vit_ae_plus_plus_torch.models import vit

    if control == "local_keys":
        return mock.patch.object(tm, "data_coords", lambda mesh=None: (0, 1))
    if control == "local_moments":
        return mock.patch.object(vit, "psum", lambda t, _mesh, _axis: t)
    return contextlib.nullcontext()


def run_ddp_moco(mesh, arch, weights, control=None):
    """One data-parallel MoCo step (LARS) on this rank's rows of the global
    batch under `mesh` -> (loss, gradients, running statistics of both
    encoders after the step, the parameters after the step, flat)."""
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk
    from vit_ae_plus_plus_torch.train.optim import make_lars

    with narrow(arch):
        model = _port_moco(arch, weights["base"])
        mom = _port_moco(arch, weights["momentum"]).base_encoder
    state = tmk.create_moco_state(model, make_lars(MOCO_LR))
    state.momentum_encoder.load_state_dict(mom.state_dict(), strict=True)
    x1, x2 = (torch.from_numpy(_rows(mesh, x)) for x in moco_views())
    with set_mesh(mesh), ddp_control(control):
        state, metrics = tmk.make_moco_train_step(model)(state, x1, x2, MOCO_M)
    stats = {n: b.numpy().copy() for n, b in model.named_buffers()}
    stats.update({f"momentum.base_encoder.{n}": b.numpy().copy()
                  for n, b in state.momentum_encoder.named_buffers()})
    named = dict(model.named_parameters())
    return (float(metrics["loss"]), {n: p.grad.numpy() for n, p in named.items()}, stats,
            torch.cat([p.detach().flatten() for p in named.values()]).numpy())


def ddp_gate(result, want, tol=MOCO_TOL["vit"]) -> float:
    """The largest reading over its limit (`MOCO_TOL`), loss, gradients and
    statistics: at most 1 inside the gate."""
    loss, grads, stats = result[:3]
    want_loss, want_grads, want_stats = want
    assert set(grads) == set(want_grads) and set(want_stats) <= set(stats)
    ratios = [abs(loss - want_loss) / (tol["loss"] * abs(want_loss))]
    for kind, got, ref in (("grads", grads, want_grads), ("stats", stats, want_stats)):
        top = max(np.abs(w).max() for w in ref.values())
        ratios += [np.abs(got[n] - w).max() / (tol[kind] * np.abs(w).max() + tol["atol"] * top)
                   for n, w in ref.items()]
    return float(max(ratios))


def _jax_contrastive_model():
    from vit_ae_plus_plus_tpu.configs import ViTConfig as JViTConfig
    from vit_ae_plus_plus_tpu.models.vit import VisionTransformer3DContrastive as JaxContrastive

    return JaxContrastive(JViTConfig(**CONTR_CFG), use_proj=True)


def jax_contrastive_weights():
    import jax
    import jax.numpy as jnp

    with x64():
        x = jnp.zeros((2, 1, VOL, VOL, VOL))
        shapes = jax.eval_shape(_jax_contrastive_model().init, {"params": jax.random.PRNGKey(0)}, x, x)
    return seeded(shapes, 54)


def jax_ddp_contrastive(weights, data=2, model_axis=1):
    """JAX `make_contrastive_step` on a (data, model) mesh, (2, 1) by
    default, over the global batch -> (loss, gradients, the heads' running
    statistics after the step)."""
    import jax
    import jax.numpy as jnp

    from vit_ae_plus_plus_tpu.parallel import make_mesh as jax_mesh
    from vit_ae_plus_plus_tpu.pipelines import contrastive as jc

    orig, aug = moco_views()
    with x64():
        tx = _keeps_grads()
        params, bs = (jax.tree.map(jnp.array, weights[k]) for k in ("params", "batch_stats"))
        state = jc.ContrastiveState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bs,
                                    opt_state=tx.init(params), tx=tx)
        mesh = jax_mesh(data=data, model=model_axis, devices=jax.devices()[:data * model_axis])
        step = jc.make_contrastive_step(_jax_contrastive_model(), mesh=mesh)
        new, metrics = step(state, jnp.asarray(orig), jnp.asarray(aug))
        new = jax.device_get(new)
    grads = params_from_jax(jax.tree.map(np.asarray, new.opt_state), PATCH, 1)
    stats = params_from_jax(new.params, PATCH, 1, new.batch_stats)
    return (float(metrics["loss"]), {k: v.numpy() for k, v in grads.items()},
            {k: v.numpy() for k, v in stats.items() if k.endswith(("running_mean", "running_var"))})


def run_ddp_contrastive(mesh, weights, control=None):
    """One data-parallel contrastive step (the unmasked AdamW) on this rank's
    rows -> (loss, gradients, statistics, the parameters after the step)."""
    from vit_ae_plus_plus_torch.configs import ViTConfig
    from vit_ae_plus_plus_torch.models import VisionTransformer3DContrastive
    from vit_ae_plus_plus_torch.pipelines.contrastive import ContrastiveState, make_contrastive_step
    from vit_ae_plus_plus_torch.train.optim import AdamW, decay_everything

    model = VisionTransformer3DContrastive(ViTConfig(**CONTR_CFG), use_proj=True).double()
    model.load_state_dict(params_from_jax(weights["params"], PATCH, 1, weights["batch_stats"]), strict=True)
    state = ContrastiveState(model=model, tx=AdamW(model, CONTR_LR, decay_mask=decay_everything))
    orig, aug = (torch.from_numpy(_rows(mesh, x)) for x in moco_views())
    with set_mesh(mesh), ddp_control(control):
        state, metrics = make_contrastive_step(model)(state, orig, aug)
    named = dict(model.named_parameters())
    return (float(metrics["loss"]), {n: p.grad.numpy() for n, p in named.items()},
            {n: b.numpy().copy() for n, b in model.named_buffers()},
            torch.cat([p.detach().flatten() for p in named.values()]).numpy())


def moco_kfold_configs(data_dir):
    """2 folds of 9 training volumes at batch 4 (2 steps an epoch), 2
    epochs, f32, with resume states."""
    data_cfg = DataConfig(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1)
    train_cfg = TrainConfig(batch_size=4, epochs=2, compute_dtype="float32", seed=3, resume=True)
    return data_cfg, train_cfg


def run_moco_kfold(work, data_dir, n_devices=None):
    """`moco_kfold` (the scipy augmentation policy) into `work`."""
    from unittest import mock

    from vit_ae_plus_plus_torch.data import transforms as tt
    from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk

    data_cfg, train_cfg = moco_kfold_configs(data_dir)
    with mock.patch.object(tmk, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never")):
        return tmk.moco_kfold(data_cfg, train_cfg, work, n_splits=2, n_devices=n_devices, device="cpu", **MOCO)


def run_ddp_moco_kfold(mesh, work, data_dir):
    """On 2 ranks: `moco_kfold`, then again with resume after the features
    were moved aside (every fold restores its last epoch, trains no more
    and extracts again from its min-loss `.pth`). -> (results, resumed
    results)."""
    from vit_ae_plus_plus_torch.parallel import barrier

    with set_mesh(mesh):
        first = run_moco_kfold(work, data_dir, n_devices=2)
        barrier(mesh)
        if mesh.coords["data"] == 0:
            feat_dir = os.path.join(work, "ssl_features_dir")
            for name in os.listdir(feat_dir):
                os.replace(os.path.join(feat_dir, name), os.path.join(feat_dir, name + ".first"))
        barrier(mesh)
        resumed = run_moco_kfold(work, data_dir, n_devices=2)
    return first, resumed
