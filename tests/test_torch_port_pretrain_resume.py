"""The port's `pretrain-kfold` on its own, on the CPU at the tiny preset:
kill and resume, the checkpoint cadence, the cross-fold skip, the refused
settings, and the CLI with its INI bridge and work-dir lock.

The kill/resume run is transform-free: each volume's augmentation is drawn
from [seed, item, access count], and the access counts restart with the
process (in the JAX package too), so a resumed run draws other
augmentations than an uninterrupted one. Everything else a resumed fold
depends on (model, BatchNorm statistics, AdamW state and count, step,
masking generator, shuffle epoch, best loss) is restored, so the resumed
run's epochs equal the uninterrupted run's bitwise.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu import cli as jcli
from vit_ae_plus_plus_torch import cli
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as tpk
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict

REPO = Path(__file__).resolve().parents[1]
MODEL = "contr_mae_vit_tiny_patch4"
FOLDS = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share a few cores, and the tiny
    model's ops on an oversubscribed thread pool ran ten times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def brats_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    np.save(root / "x_whole_ssl.npy", rng.standard_normal((16, 16, 16, 16, 1)).astype(np.float32))
    np.save(root / "y_whole_ssl.npy", np.array([0, 1] * 8))
    return str(root)


@pytest.fixture
def scipy_policy(monkeypatch):
    """The scipy augmentation policy (the native library is left to the data
    tests, which build it)."""
    monkeypatch.setattr(tpk, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never"))


def _cfgs(brats_dir, **train):
    data_cfg = DataConfig(name="brats", base_path=brats_dir, volume_size=16, in_channels=1)
    kw = dict(batch_size=4, patch_size=4, warmup_epochs=1, compute_dtype="float32", contr_weight=0.001)
    return data_cfg, TrainConfig(**{**kw, **train})


def _run(brats_dir, work, **train):
    data_cfg, train_cfg = _cfgs(brats_dir, **train)
    return tpk.pretrain_kfold(data_cfg, train_cfg, str(work), model_name=MODEL, n_splits=FOLDS, device="cpu")


def _outputs(work):
    """-> (log rows without the timing, min-loss state dicts, features)."""
    with open(os.path.join(work, "checkpoints", "log.txt")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        assert row.pop("train_volumes_per_sec") > 0
    ckpts = [load_reference_state_dict(os.path.join(work, "checkpoints", f"fold_{k}", "checkpoint-min_loss.pth"))
             for k in range(FOLDS)]
    feats = {(tag, k): np.load(os.path.join(work, "ssl_features_dir", f"{tag}_contrast_ssl_features_split_{k}.npy"))
             for tag in ("train", "test") for k in range(FOLDS)}
    return rows, ckpts, feats


def _assert_same(a, b):
    for sa, sb in zip(a[1], b[1]):
        assert list(sa) == list(sb)
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a[2].keys() == b[2].keys()
    for key in a[2]:
        np.testing.assert_array_equal(a[2][key], b[2][key])


class _Killed(Exception):
    pass


def test_killed_run_resumes_bitwise(brats_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(tpk, "default_ssl_transforms", lambda: None)
    whole = tmp_path / "whole"
    want = _run(brats_dir, whole, epochs=3, resume=True)

    class KilledAfterEpoch1(tpk.CheckpointManager):
        def save(self, state, epoch, min_loss=float("inf")):
            super().save(state, epoch, min_loss)
            if epoch == 1:
                raise _Killed

    work = tmp_path / "killed"
    monkeypatch.setattr(tpk, "CheckpointManager", KilledAfterEpoch1)
    with pytest.raises(_Killed):
        _run(brats_dir, work, epochs=3, resume=True)
    with open(work / "checkpoints" / "log.txt") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    monkeypatch.undo()
    monkeypatch.setattr(tpk, "default_ssl_transforms", lambda: None)
    got = _run(brats_dir, work, epochs=3, resume=True)

    assert got == want
    rows, whole_out = _outputs(work), _outputs(whole)
    # fold 0 resumed at epoch 2 after the killed run's rows for 0 and 1
    assert [(r["fold"], r["epoch"]) for r in rows[0]] == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    assert rows[0][2:] == whole_out[0][2:]
    _assert_same(rows, whole_out)


def test_ckpt_every_cadence_matches_every_epoch(brats_dir, tmp_path, scipy_policy):
    """`ckpt_every` changes when state is written, never what trains or which
    weights win; two fresh runs also agree bitwise (run-to-run determinism)."""
    outs = {}
    for every in (1, 3):
        work = tmp_path / f"every_{every}"
        results = _run(brats_dir, work, epochs=4, ckpt_every=every, resume=True)
        outs[every] = (results, _outputs(work))
        assert sorted(os.listdir(work / "checkpoints" / "fold_0" / "resume")) == ["checkpoint.pth", "layout.json"]
    assert outs[1][0] == outs[3][0]
    assert outs[1][1][0] == outs[3][1][0]
    _assert_same(outs[1][1], outs[3][1])


def test_resume_skips_completed_folds(brats_dir, tmp_path, scipy_policy):
    first = _run(brats_dir, tmp_path, epochs=1, resume=True)
    assert all(np.isfinite(r["min_loss"]) for r in first.values())
    second = _run(brats_dir, tmp_path, epochs=1, resume=True)
    assert second == {k: {"skipped": True} for k in range(FOLDS)}


REFUSED = {
    "device_augment": dict(device_augment=True),
    "device_data": dict(device_data=True),
    "perceptual_weight": dict(perceptual_weight=0.1),
    "accum_iter": dict(accum_iter=2),
    "fsdp": dict(fsdp=True),
    "pipe_devices": dict(pipe_devices=2),
    "mesh_shape": dict(mesh_shape=(2,)),
    "n_devices": dict(),
}


@pytest.mark.parametrize("setting", list(REFUSED))
def test_unported_settings_are_refused_before_any_work(setting, tmp_path):
    # a data path that does not exist: reading it would raise another error
    data_cfg, train_cfg = _cfgs(str(tmp_path / "no_data"), **REFUSED[setting])
    n_devices = 2 if setting == "n_devices" else None
    work = tmp_path / "work"
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        tpk.pretrain_kfold(data_cfg, train_cfg, str(work), model_name=MODEL, n_splits=FOLDS,
                           n_devices=n_devices, device="cpu")
    assert os.listdir(work) == [".writer.lock"]


def _argv(data_dir, work, *extra):
    return ["pretrain-kfold", "--device", "cpu", "--data-path", data_dir, "--work-dir", str(work),
            "--model", MODEL, "--volume-size", "16", "--patch-size", "4", "--batch-size", "4",
            "--epochs", "2", "--n-splits", "2", "--compute-dtype", "float32", *extra]


def test_cli_pretrain_kfold(brats_dir, tmp_path, capsys, scipy_policy):
    work = tmp_path / "run"
    assert cli.main(_argv(brats_dir, work, "--profile-dir", str(tmp_path / "prof"))) == 0
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(results) == {"0", "1"} and all(np.isfinite(r["min_loss"]) for r in results.values())
    files = sorted(str(p.relative_to(work)) for p in work.rglob("*") if p.is_file())
    assert [f for f in files if not f.startswith("logs/")] == sorted(
        [".writer.lock", "checkpoints/log.txt"]
        + [f"checkpoints/fold_{k}/checkpoint-min_loss.pth" for k in range(FOLDS)]
        + [f"k_fold/indices_file/{s}_{k}.npy" for s in ("train", "test") for k in range(FOLDS)]
        + [f"ssl_features_dir/{t}_contrast_ssl_{w}_split_{k}.npy"
           for t in ("train", "test") for w in ("features", "labels") for k in range(FOLDS)])
    assert len([f for f in files if f.startswith("logs/events.out.tfevents.")]) == 1
    # one steady epoch traced per fold (epoch start_epoch + 1)
    assert sorted(os.listdir(tmp_path / "prof")) == ["fold_0_epoch_1.json", "fold_1_epoch_1.json"]
    with open(work / "checkpoints" / "log.txt") as f:
        assert len(f.readlines()) == FOLDS * 2


INI = """[DATASET]
name = brats
in_channels = 1
volume_size = 16
num_classes = 3
use_z_score = false

[K_FOLD]
epochs = 1
batch_size = 4
contr_weight = 0.001
mask_ratio = 0.5
patch_size = 4
output_dir = out
"""


@pytest.mark.parametrize("with_ini", [False, True])
def test_cli_configs_equal_the_jax_commands(with_ini, tmp_path):
    extra = ["--seed", "7", "--ckpt-every", "2", "--resume", "--ln-dtype", "bfloat16", "--no-use-z-score"]
    if with_ini:
        (tmp_path / "config.ini").write_text(INI)
        extra += ["--config", str(tmp_path / "config.ini")]
    args = cli.build_parser().parse_args(_argv("", tmp_path / "w", *extra))
    got, want = cli.configs_from_args(args), jcli._configs(args)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    if with_ini:
        assert got[1].epochs == 1 and got[1].mask_ratio == 0.5 and got[0].num_classes == 3


def test_cli_exits_2_on_a_work_dir_locked_by_another_process(brats_dir, tmp_path):
    work = tmp_path / "locked"
    holder = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from vit_ae_plus_plus_torch.utils.locking import acquire_workdir_lock; "
         f"acquire_workdir_lock({str(work)!r}); print('held', flush=True); sys.stdin.read()"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(REPO))
    try:
        assert holder.stdout.readline().strip() == "held"
        assert cli.run(_argv(brats_dir, work)) == 2
    finally:
        holder.communicate(timeout=30)
    assert os.listdir(work) == [".writer.lock"]
