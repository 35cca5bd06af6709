"""The port's `moco-kfold` and `moco-extract` against the JAX package's, on
the CPU.

- `moco_kfold` for both trunks on a synthetic BraTS tree (16 volumes of
  16^3, 2 folds of 8 training volumes at batch 4: 2 steps an epoch, 2
  epochs, f32, the scipy augmentation policy in both), JAX's initial
  weights injected into the port: the fold index files equal; every
  `log.txt` row's loss within 1e-5 relative (`LOSS_RTOL`); each fold's
  min-loss `.pth` loads into the port's model; each features file within
  `FEAT_TOL` of JAX's and each labels file equal. The ViT is depth 2, width
  24, patch 4; the heads mlp_dim 16, dim 8; the ResNet-10 a quarter wide.
- Kill and resume (transform-free, as in test_torch_port_pretrain_resume.py:
  augmentation draws restart with the process): a run killed after epoch
  0's resume state and resumed equals an uninterrupted one bitwise (rows,
  min-loss weights, features), and `ckpt_every` 2 equals 1 bitwise.
- `moco_extract` on a work dir (every fold, then `fold_idx`) rewrites
  `moco_kfold`'s own dumps bitwise; on one `.pth` it extracts the whole
  dataset (a last partial batch padded), within `FEAT_TOL` of the JAX
  package's `moco_extract` on its own fold-0 checkpoint.
- The CLI on the CPU, and its refusal of `--fsdp` without a data mesh
  before any data is read, as the JAX package's (`--n-devices N` runs N
  ranks: tests/test_torch_port_moco_ddp.py; `--fsdp --n-devices 2`:
  tests/test_torch_port_ring_flash.py).
"""

import contextlib
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.models import resnet3d as jr
from vit_ae_plus_plus_tpu.pipelines import moco_kfold as jmk
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.cli import run as cli_run
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.models import resnet3d as tr
from vit_ae_plus_plus_torch.pipelines import moco_kfold as tmk
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

N_VOLS, VOL, FOLDS, EPOCHS, BATCH, PATCH, DIM, MLP_DIM = 16, 16, 2, 2, 4, 4, 8, 16
VIT = dict(patch_size=PATCH, embed_dim=24, depth=2, num_heads=3)
NARROW = (16, 32, 64, 128)
MOCO = dict(moco_dim=DIM, moco_mlp_dim=MLP_DIM, vit_overrides=VIT)
# f32 on both sides: the losses differ in summation order only, and the
# features after 4 LARS steps by what that order carries through them
LOSS_RTOL, FEAT_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Module-wide, so that it holds in the module-scoped `runs` too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    labels = np.array([0, 1] * (N_VOLS // 2))
    vols = rng.standard_normal((N_VOLS, VOL, VOL, VOL, 1)) + 0.3 * labels[:, None, None, None, None]
    np.save(root / "x_whole_ssl.npy", vols.astype(np.float32))
    np.save(root / "y_whole_ssl.npy", labels)
    return str(root)


def _configs(data_dir, **train):
    dkw = dict(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1, use_z_score=True)
    tkw = dict(epochs=EPOCHS, batch_size=BATCH, compute_dtype="float32", seed=3, **train)
    return (JDataConfig(**dkw), JTrainConfig(**tkw)), (DataConfig(**dkw), TrainConfig(**tkw))


def _port_builder(init=None):
    """The port's `build_moco_model` with the test's sizes; with `init`
    (JAX's variables), its `init_weights` loads them instead of drawing."""
    real = tmk.build_moco_model

    def build(data_cfg, compute_dtype="float32", arch="vit", resnet_depth=10, *_args, **_kw):
        model = real(data_cfg, compute_dtype, arch, resnet_depth, **MOCO)
        if init is not None:
            model.init_weights = lambda _generator: model.load_state_dict(
                params_from_jax(init["params"], PATCH, 1, init["batch_stats"]), strict=True) or model
        return model

    return build


@contextlib.contextmanager
def _narrow(arch):
    with pytest.MonkeyPatch.context() as mp:
        if arch == "resnet":
            mp.setattr(jr, "INPLANES", NARROW)
            mp.setattr(tr, "INPLANES", NARROW)
        yield mp


class _JaxOnce:
    """`jax` as the JAX pipeline module sees it, but `jit` compiles a
    function once for its code and what it closes over (by repr): the
    extraction re-creates its jitted lambda over the same model on every
    call."""

    def __init__(self):
        self.jitted = {}

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        key = (fn.__code__, tuple(repr(c.cell_contents) for c in fn.__closure__ or ()), repr(sorted(kwargs.items())))
        if key not in self.jitted:
            self.jitted[key] = jax.jit(fn, **kwargs)
        return self.jitted[key]


def _jax_fast(mp, inits, saved):
    """The JAX package's pipeline as it runs, compiled once: its model's
    init jitted (and recorded into `inits`; the extraction's init of one
    volume, of which its caller reads only the shapes, given the zeros of
    the recorded one), one step for every fold (the fold's schedule,
    optimizer and jitted step built once), the extraction's jitted trunk
    compiled once (`_JaxOnce`), and its orbax checkpoints held in memory by
    path."""
    real_build, real_step = jmk.build_moco_model, jmk.make_moco_train_step

    def build(*args, **kwargs):
        key = repr((args, sorted(kwargs.items())))
        if key not in _JAX_MODELS:
            _JAX_MODELS[key] = recorded(real_build(*args, **kwargs))
        return _JAX_MODELS[key]

    def recorded(model):
        init = jax.jit(functools.partial(model.init, use_predictor=True))

        class Recorded:
            def __getattr__(self, name):
                return getattr(model, name)

            def init(self, rngs, x, use_predictor=True):
                if x.shape[0] == 1 and inits:
                    return jax.tree.map(np.zeros_like, inits[0])
                inits.append(jax.tree.map(np.asarray, init(rngs, x)))
                return inits[-1]

        return Recorded()

    steps = {}

    def make_step(model, temperature=1.0, mesh=None, state_shardings=None):
        return steps.setdefault((id(model), temperature), real_step(model, temperature))

    mp.setattr(jmk, "build_moco_model", build)
    mp.setattr(jmk, "make_moco_train_step", make_step)
    mp.setattr(jmk, "save_params", lambda path, tree: saved.__setitem__(path, jax.device_get(tree)))
    mp.setattr(jmk, "load_params", lambda path, template: saved[path])
    mp.setattr(jmk, "warmup_cosine_schedule", functools.lru_cache()(jmk.warmup_cosine_schedule))
    mp.setattr(jmk, "make_lars", functools.lru_cache()(jmk.make_lars))
    mp.setattr(jmk, "default_ssl_transforms", lambda: jt.default_ssl_transforms(native="never"))
    mp.setattr(jmk, "jax", _JAX_ONCE)


_JAX_ONCE = _JaxOnce()
_JAX_MODELS = {}  # one JAX model (and so one compile of its init and trunk) per configuration


@pytest.fixture(scope="module", params=["vit", "resnet"])
def runs(request, data_dir, tmp_path_factory):
    """JAX's `moco_kfold` and the port's from JAX's init -> (arch, JAX work
    dir, port work dir, port results, JAX results, JAX's checkpoints by
    path)."""
    arch = request.param
    (jd, jtc), (td, tc) = _configs(data_dir)
    root = tmp_path_factory.mktemp(f"moco_{arch}")
    inits, saved = [], {}
    with _narrow(arch) as mp:
        _jax_fast(mp, inits, saved)
        want = jmk.moco_kfold(jd, jtc, str(root / "jax"), n_splits=FOLDS, arch=arch, **MOCO)
        mp.setattr(tmk, "build_moco_model", _port_builder(inits[0]))
        mp.setattr(tmk, "default_ssl_transforms", lambda: tt.default_ssl_transforms(native="never"))
        got = tmk.moco_kfold(td, tc, str(root / "port"), n_splits=FOLDS, arch=arch, device="cpu", **MOCO)
    return arch, root / "jax", root / "port", got, want, saved


def _rows(log):
    with open(log) as f:
        return [json.loads(line) for line in f]


def _features(work):
    d = os.path.join(work, "ssl_features_dir")
    return {name: np.load(os.path.join(d, name)) for name in sorted(os.listdir(d))}


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_moco_kfold_matches_jax(runs):
    arch, j_work, t_work, got, want, _ = runs
    for tag in ("train", "test"):
        for k in range(FOLDS):
            name = f"{tag}_{k}.npy"
            assert np.array_equal(np.load(t_work / "k_fold" / "indices_file" / name),
                                  np.load(j_work / "k_fold" / "indices_file" / name))
    rows, want_rows = _rows(t_work / "log.txt"), _rows(j_work / "log.txt")
    assert [(r["fold"], r["epoch"]) for r in rows] == [(k, e) for k in range(FOLDS) for e in range(EPOCHS)]
    for g, w in zip(rows, want_rows):
        assert set(g) == set(w) == {"train_loss", "epoch", "fold"}
        assert abs(g["train_loss"] - w["train_loss"]) <= LOSS_RTOL * abs(w["train_loss"]), (g, w)
    assert sorted(got) == sorted(want) == list(range(FOLDS))
    for k in range(FOLDS):
        assert abs(got[k]["min_loss"] - want[k]["min_loss"]) <= LOSS_RTOL * abs(want[k]["min_loss"])
        assert got[k]["min_loss"] == min(r["train_loss"] for r in rows if r["fold"] == k)
        sd = torch.load(tmk.min_loss_path(str(t_work), k), map_location="cpu", weights_only=True)
        with _narrow(arch):
            _port_builder()(DataConfig(volume_size=VOL), arch=arch).load_state_dict(sd, strict=True)
    feats, want_feats = _features(t_work), _features(j_work)
    assert feats.keys() == want_feats.keys() and len(feats) == 4 * FOLDS
    width = {"vit": VIT["embed_dim"], "resnet": NARROW[-1]}[arch]
    for name, w in want_feats.items():
        if "labels" in name:
            assert np.array_equal(feats[name], w), name
        else:
            assert feats[name].shape == w.shape == (N_VOLS // FOLDS, width) and feats[name].dtype == np.float32
            assert _rel(feats[name], w) <= FEAT_TOL, (name, _rel(feats[name], w))


def test_moco_extract_both_modes(runs, data_dir, tmp_path):
    arch, j_work, t_work, _, _, saved = runs
    _, (td, _) = _configs(data_dir)
    with _narrow(arch) as mp:
        mp.setattr(tmk, "build_moco_model", _port_builder())
        out = tmk.moco_extract(td, str(t_work), str(tmp_path / "all"), batch_size=BATCH, arch=arch, n_splits=FOLDS,
                               device="cpu")
        assert sorted(out) == sorted(f"fold{k}_{t}" for k in range(FOLDS) for t in ("train", "test"))
        again, dumps = _features(tmp_path / "all"), _features(t_work)
        assert again.keys() == dumps.keys() and all(np.array_equal(again[n], dumps[n]) for n in dumps)
        out = tmk.moco_extract(td, str(t_work), str(tmp_path / "one"), batch_size=BATCH, arch=arch,
                               n_splits=FOLDS, fold_idx=1, device="cpu")
        assert sorted(out) == ["fold1_test", "fold1_train"]
        if arch != "vit":
            return
        ckpt = tmk.min_loss_path(str(t_work), 0)
        out = tmk.moco_extract(td, ckpt, str(tmp_path / "whole"), batch_size=BATCH * 2 - 1, arch=arch,
                               device="cpu")
    assert list(out) == ["whole"]
    # the JAX package's `moco_extract` on its own fold-0 checkpoint
    jd = _configs(data_dir)[0][0]
    with pytest.MonkeyPatch.context() as mp:
        _jax_fast(mp, [], saved)
        jmk.moco_extract(jd, str(j_work / "checkpoints" / "fold_0" / "checkpoint-min_loss"),
                         str(tmp_path / "jax"), batch_size=BATCH, arch=arch, **MOCO)
    feats, want = _features(tmp_path / "whole"), _features(tmp_path / "jax")
    assert feats.keys() == want.keys() == {"whole_contrast_ssl_features_split_0.npy",
                                           "whole_contrast_ssl_labels_split_0.npy"}
    name = "whole_contrast_ssl_features_split_0.npy"
    assert feats[name].shape == want[name].shape == (N_VOLS, VIT["embed_dim"])
    assert _rel(feats[name], want[name]) <= FEAT_TOL, _rel(feats[name], want[name])
    assert np.array_equal(feats["whole_contrast_ssl_labels_split_0.npy"], want["whole_contrast_ssl_labels_split_0.npy"])


class _Killed(Exception):
    pass


def _port_run(data_dir, work, **train):
    _, (td, tc) = _configs(data_dir, **train)
    return tmk.moco_kfold(td, tc, str(work), n_splits=FOLDS, device="cpu", **MOCO)


def _outputs(work):
    rows = _rows(os.path.join(work, "log.txt"))
    ckpts = [torch.load(tmk.min_loss_path(str(work), k), map_location="cpu", weights_only=True)
             for k in range(FOLDS)]
    return rows, ckpts, _features(work)


def _assert_same(a, b):
    assert a[0] == b[0]
    for sa, sb in zip(a[1], b[1]):
        assert list(sa) == list(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert a[2].keys() == b[2].keys() and all(np.array_equal(a[2][n], b[2][n]) for n in a[2])


def test_killed_run_resumes_bitwise_and_ckpt_every(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(tmk, "default_ssl_transforms", lambda: None)
    whole = _port_run(data_dir, tmp_path / "whole", resume=True)
    real = tmk.save_resume

    def killed_after_epoch_0(path, state, epoch, min_loss):
        real(path, state, epoch, min_loss)
        if epoch == 0:
            raise _Killed

    monkeypatch.setattr(tmk, "save_resume", killed_after_epoch_0)
    with pytest.raises(_Killed):
        _port_run(data_dir, tmp_path / "killed", resume=True)
    assert [r["epoch"] for r in _rows(tmp_path / "killed" / "log.txt")] == [0]
    monkeypatch.setattr(tmk, "save_resume", real)
    assert _port_run(data_dir, tmp_path / "killed", resume=True) == whole
    resumed, want = _outputs(tmp_path / "killed"), _outputs(tmp_path / "whole")
    # fold 0 resumed at epoch 1 after the killed run's row for epoch 0
    assert [(r["fold"], r["epoch"]) for r in resumed[0]] == [(k, e) for k in range(FOLDS) for e in range(EPOCHS)]
    _assert_same(resumed, want)
    assert sorted(os.listdir(tmp_path / "killed" / "checkpoints" / "fold_0")) == [
        "checkpoint-min_loss.pth", "resume-state.pth"]

    assert _port_run(data_dir, tmp_path / "every2", ckpt_every=2) == whole
    _assert_same(_outputs(tmp_path / "every2"), want)


def test_moco_cli_and_refusals(data_dir, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tmk, "default_ssl_transforms", lambda: None)
    monkeypatch.setattr(tmk, "build_moco_model", _port_builder())
    common = ["--data-path", data_dir, "--volume-size", str(VOL), "--batch-size", str(BATCH), "--epochs", "1",
              "--n-splits", "2", "--compute-dtype", "float32", "--device", "cpu"]
    work = str(tmp_path / "cli")
    assert cli_main(["moco-kfold", *common, "--work-dir", work]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["0", "1"] and all(np.isfinite(r["min_loss"]) for r in out.values())
    assert cli_main(["moco-extract", *common, "--work-dir", str(tmp_path / "x"), "--checkpoint", work,
                     "--fold", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == ["fold0_test", "fold0_train"]
    assert np.array_equal(np.load(out["fold0_test"]), np.load(os.path.join(
        work, "ssl_features_dir", "test_contrast_ssl_features_split_0.npy")))
    # refused before any data is read
    missing = ["--data-path", str(tmp_path / "none"), "--work-dir", str(tmp_path / "w")]
    assert cli_run(["moco-kfold", *missing, "--fsdp"]) == 2
    assert "--fsdp needs a data mesh (--n-devices > 1)" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["moco-kfold"], ["moco-extract", "--checkpoint", work]):
        assert cli_run([*cmd, *missing]) == 2
        assert "no CUDA device" in capsys.readouterr().err
