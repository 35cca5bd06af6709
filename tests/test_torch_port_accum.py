"""Gradient accumulation in the port (train/optim.py `MultiSteps`, the JAX
package's `make_adamw(accum_iter=k)`, which is optax's `MultiSteps`), on the
CPU:

- the accumulating AdamW against optax over k = 2 and 3 mini-steps an
  update, with global-norm clipping and a warmup-cosine schedule of 4 steps
  an epoch over 12 mini-steps (the accumulation crosses the schedule's epoch
  boundaries): after every mini-step the parameters, the update count,
  the mini-step and the running mean within 1e-6 relative (f32 on both
  sides, another order of operations); after the mini-steps that emit no
  update the parameters bitwise unchanged;
- `pretrain_kfold` with `accum_iter=2` and no `lr` (so the rate is blr *
  batch * 2 / 256) against the JAX package's, through the harness of
  tests/test_torch_port_pretrain_kfold.py (JAX's initial weights and noise
  injected): each log row's losses within 1e-4 relative and `train_lr`
  within 1e-6;
- a run killed after an epoch that ends in the middle of an accumulation
  (2 steps an epoch, 3 mini-steps an update) resumes bitwise to the
  uninterrupted run, with the options off the default path on
  (`device_data`, `device_augment`, the perceptual term): the resume state
  holds the running mean and the mini-step, and the augmentation's draws
  depend on (seed, fold, epoch, step) alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.pipelines import pretrain_kfold as jpk
from vit_ae_plus_plus_tpu.train.optim import make_adamw as jax_make_adamw
from vit_ae_plus_plus_tpu.train.optim import warmup_cosine_schedule as jax_schedule
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as tpk
from vit_ae_plus_plus_torch.models import MODEL_ZOO, build_model
from vit_ae_plus_plus_torch.train import create_train_state, make_adamw, warmup_cosine_schedule
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict
from vit_ae_plus_plus_torch.train.optim import MultiSteps

from test_torch_port_pretrain_kfold import FOLDS, LOSS_RTOL, LR_RTOL, _log, _rel, _run, brats_dir  # noqa: F401

OPT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= OPT_TOL * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("clip_grad", [None, 0.5])
@pytest.mark.parametrize("k", [2, 3])
def test_accumulating_adamw_matches_optax_multisteps(k, clip_grad):
    init = {"w": _np((4, 3), 20), "b": _np((3,), 21), "tok": _np((1, 1, 3), 22)}
    grads = [{n: _np(v.shape, 30 + 3 * i + j) for j, (n, v) in enumerate(init.items())} for i in range(12)]
    schedule = (1e-2, 1e-4, 1.0, 3.0, 4)  # base, min, warmup epochs, epochs, steps per epoch

    tx = jax_make_adamw(jax_schedule(*schedule), weight_decay=0.05, clip_grad=clip_grad, accum_iter=k)
    params = {n: jnp.asarray(v) for n, v in init.items()}
    opt_state = tx.init(params)
    update = jax.jit(tx.update)  # one compile, not one op-by-op dispatch of optax's chain a mini-step

    module = torch.nn.Module()
    for n, v in init.items():
        module.register_parameter(n, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = make_adamw(warmup_cosine_schedule(*schedule), weight_decay=0.05, clip_grad=clip_grad, accum_iter=k)(module)
    assert isinstance(opt, MultiSteps)
    names = [n for n, _ in module.named_parameters()]
    for i, g in enumerate(grads):
        updates, opt_state = update({n: jnp.asarray(v) for n, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        before = {n: p.detach().clone() for n, p in module.named_parameters()}
        for n, p in module.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
        assert opt.mini_step == int(opt_state.mini_step) == (i + 1) % k
        assert opt.count == int(opt_state.gradient_step) == (i + 1) // k
        for n, p in module.named_parameters():
            _close(p.detach().numpy(), params[n])
            if (i + 1) % k:
                assert torch.equal(p.detach(), before[n]), (i, n)
        for n, a in zip(names, opt.acc):
            _close(a.numpy(), opt_state.acc_grads[n])


def test_pretrain_kfold_with_accumulation_matches_jax(brats_dir, tmp_path, monkeypatch):
    dkw = dict(name="brats", base_path=brats_dir, volume_size=16, in_channels=1, use_z_score=True)
    tkw = dict(epochs=3, batch_size=4, patch_size=4, warmup_epochs=1, compute_dtype="float32",
               contr_weight=0.001, accum_iter=2)
    rng = np.random.default_rng(18)
    noises = [rng.random((8, 64)).astype(np.float32) for _ in range(FOLDS)]
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    want, jrec = _run(jpk, jt, JDataConfig(**dkw), JTrainConfig(**tkw), jwork, noises, monkeypatch)
    got, _ = _run(tpk, tt, DataConfig(**dkw), TrainConfig(**tkw), twork, noises, monkeypatch, jax_init=jrec["init"])
    jlog, tlog = _log(jwork), _log(twork)
    assert [list(r) for r in tlog] == [list(r) for r in jlog] and len(tlog) == 3 * FOLDS
    for t, j in zip(tlog, jlog):
        for key in ("train_loss", "train_reconstruction_loss", "train_edge_map_loss"):
            assert _rel(t[key], j[key]) <= LOSS_RTOL, (key, t, j)
        assert _rel(t["train_lr"], j["train_lr"]) <= LR_RTOL, (t, j)
    # the rate counts the accumulated batch: blr * 4 * 2 / 256 at the end of warmup
    assert abs(tlog[0]["train_lr"] - 1e-3 * 8 / 256 * 0.5) <= 1e-12
    for fold in range(FOLDS):
        assert _rel(got[fold]["min_loss"], want[fold]["min_loss"]) <= LOSS_RTOL


class _Killed(Exception):
    pass


def _run_port(brats_dir, work, **train):
    data_cfg = DataConfig(name="brats", base_path=brats_dir, volume_size=16, in_channels=1)
    train_cfg = TrainConfig(batch_size=4, patch_size=4, warmup_epochs=1, compute_dtype="float32", contr_weight=0.001,
                            epochs=3, resume=True, accum_iter=3, device_augment=True, device_data=True,
                            perceptual_weight=0.1, **train)
    return tpk.pretrain_kfold(data_cfg, train_cfg, str(work), model_name="contr_mae_vit_tiny_patch4",
                              n_splits=FOLDS, device="cpu")


def test_a_run_killed_mid_accumulation_resumes_bitwise(brats_dir, tmp_path, monkeypatch):
    whole = _run_port(brats_dir, tmp_path / "whole")
    saved = []

    class KilledAfterEpoch1(tpk.CheckpointManager):
        def save(self, state, epoch, min_loss=float("inf")):
            super().save(state, epoch, min_loss)
            saved.append((state.tx.mini_step, float(sum(a.abs().sum() for a in state.tx.acc))))
            if epoch == 1:
                raise _Killed

    monkeypatch.setattr(tpk, "CheckpointManager", KilledAfterEpoch1)
    with pytest.raises(_Killed):
        _run_port(brats_dir, tmp_path / "cut")
    assert saved[-1][0] == 1 and saved[-1][1] > 0  # 4 mini-steps: one update, one gradient held
    monkeypatch.undo()
    assert _run_port(brats_dir, tmp_path / "cut") == whole
    rows, cut = ([{k: v for k, v in r.items() if k != "train_volumes_per_sec"} for r in _log(work)]
                 for work in (tmp_path / "whole", tmp_path / "cut"))
    assert cut == rows and all(r["train_perceptual_loss"] > 0 for r in rows)
    for fold in range(FOLDS):
        a = load_reference_state_dict(os.path.join(tmp_path, "whole", "checkpoints", f"fold_{fold}",
                                                   "checkpoint-min_loss.pth"))
        b = load_reference_state_dict(os.path.join(tmp_path, "cut", "checkpoints", f"fold_{fold}",
                                                   "checkpoint-min_loss.pth"))
        assert all(torch.equal(a[k], b[k]) for k in a)
    # the resume state restored into a run without accumulation is refused
    model = build_model(MODEL_ZOO["contr_mae_vit_tiny_patch4"](volume_size=16, patch_size=4))
    mgr = tpk.CheckpointManager(os.path.join(tmp_path, "cut", "checkpoints", "fold_0", "resume"))
    with pytest.raises(ValueError, match="accum_iter"):
        mgr.restore(create_train_state(model, make_adamw(1e-3)))
