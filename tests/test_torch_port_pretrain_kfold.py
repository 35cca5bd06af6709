"""The port's `pretrain_kfold` against the JAX package's, on the CPU, at the
tiny preset (2 folds, 2 epochs, f32): BraTS over 16 volumes of 16^3, and
EGD over per-scan directories of four modalities (k folds over the labeled
pool; pretraining on labeled-train plus the SSL pool with offset ids).

Both pipelines run the scipy augmentation policy
(`default_ssl_transforms(native="never")`, put in each pipeline module's
namespace), whose items are bitwise equal in the two packages
(tests/test_torch_port_data.py); the JAX package's native library is never
built here. Random streams differ between the packages, so each fold's
initial weights and masking noise are injected: JAX's `create_train_state`
is wrapped to record each fold's initial params and batch_stats, which the
port's fold loads through `params_from_jax`; one fixed numpy noise array
per fold goes into both steps through `forward_fn` (JAX then compiles its
step once a fold).

Gates: the fold index files, the feature label files and the log rows'
(fold, epoch) and keys equal; each epoch's mean losses within 1e-4
relative and its `lr` within 1e-6 (JAX's schedule runs in f32); each
fold's `min_loss` within 1e-4; the features within 1e-3 of the largest
reference feature. The f32 steps differ in summation order only (one
step reads about 1e-6, tests/test_torch_port_mae.py), over 4 steps a fold.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.configs import ViTConfig as JViTConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.models import build_model as _real_build_model
from vit_ae_plus_plus_tpu.pipelines import pretrain_kfold as jpk
from vit_ae_plus_plus_tpu.train.step import make_feature_step as _real_feature_step
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as tpk
from vit_ae_plus_plus_torch.train.checkpoint import params_from_jax

from test_torch_port_mae import _jax_forward

MODEL, PATCH, BATCH, FOLDS = "contr_mae_vit_tiny_patch4", 4, 4, 2
LOSS_RTOL, LR_RTOL, FEAT_TOL = 1e-4, 1e-6, 1e-3


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


@pytest.fixture(scope="module")
def egd_dir(tmp_path_factory):
    """Six scans of four 12^3 modalities; four labeled, two in the SSL pool
    (tests/test_torch_port_data.py's tree)."""
    root = tmp_path_factory.mktemp("egd")
    rng = np.random.default_rng(0)
    split_dir = root / "splits"
    split_dir.mkdir()
    labeled, ssl = [], []
    for i in range(6):
        scan = f"MR_{i:03d}"
        (root / scan).mkdir()
        for m in ("flair", "t1ce", "t1", "t2"):
            np.save(root / scan / f"{m}.npy", (rng.standard_normal((12, 12, 12)) * (i + 1)).astype(np.float32))
        (labeled if i < 4 else ssl).append((scan, i % 2) if i < 4 else scan)
    for name, items in (("who_idh_mutation_status_annotated_mit_labels.pkl", labeled),
                        ("who_idh_mutation_status_ssl.pkl", ssl),
                        ("who_idh_mutation_status_all.pkl", [s for s, _ in labeled] + ssl)):
        with open(split_dir / name, "wb") as f:
            pickle.dump(items, f)
    return str(root)


def _run(pk, transforms_module, data_cfg, train_cfg, work, noises, monkeypatch, jax_init=None):
    """One pipeline run with the scipy policy and the injected noise. The
    JAX run (`jax_init` None) records each fold's initial weights in
    `rec["init"]`; the port's run loads them. -> (results, rec)."""
    rec = {"fold": None, "ids": {}, "init": {}}
    is_jax = jax_init is None
    monkeypatch.setattr(pk, "default_ssl_transforms",
                        lambda: transforms_module.default_ssl_transforms(native="never"))

    real_fold = pk.pretrain_one_fold

    def pretrain_one_fold(fold_idx, train_ids, *args, **kwargs):
        rec["fold"] = fold_idx
        rec["ids"][fold_idx] = np.asarray(train_ids).copy()
        return real_fold(fold_idx, train_ids, *args, **kwargs)

    real_state, real_step = pk.create_train_state, pk.make_train_step
    if is_jax:
        def create_train_state(model, *args, **kwargs):
            state = real_state(_JitInit(model), *args, **kwargs)
            # copies: the jitted step donates the state's buffers
            rec["init"][rec["fold"]] = (jax.tree.map(np.array, state.params),
                                        jax.tree.map(np.array, state.batch_stats))
            return state

        def make_train_step(model, patch_size, **kwargs):
            noise = noises[rec["fold"]]
            kwargs["forward_fn"] = lambda variables, v1, v2, _rng: _jax_forward(model, variables, v1, v2, noise)
            return real_step(model, patch_size, **kwargs)
    else:
        def create_train_state(model, tx, seed=0):
            params, batch_stats = jax_init[rec["fold"]]
            model.load_state_dict(params_from_jax(params, PATCH, data_cfg.in_channels, batch_stats), strict=True)
            return real_state(model, tx, seed=seed)

        def make_train_step(model, patch_size, **kwargs):
            noise = torch.from_numpy(noises[rec["fold"]])
            kwargs["forward_fn"] = lambda m, v1, v2, _g: m(v1, v2, mask_ratio=0.75, noise=noise)
            return real_step(model, patch_size, **kwargs)

    for name, fn in (("pretrain_one_fold", pretrain_one_fold), ("create_train_state", create_train_state),
                     ("make_train_step", make_train_step)):
        monkeypatch.setattr(pk, name, fn)
    if is_jax:
        monkeypatch.setattr(pk, "build_model", _build_model)
        monkeypatch.setattr(pk, "make_feature_step", _feature_step)
    kwargs = {} if is_jax else {"device": "cpu"}
    results = pk.pretrain_kfold(data_cfg, train_cfg, work, model_name=MODEL, n_splits=FOLDS, **kwargs)
    return results, rec


# The JAX run's `init` (MAE and grafted ViT) and feature step, compiled once
# per model config and reused by the next fold and tag. The JAX pipeline runs
# `init` op by op and compiles a feature step for each fold and tag, which
# took most of its time here; the values are the same.
_JITTED = {}


class _JitInit:
    """A flax module with its `init` compiled; every other attribute is the
    module's."""

    def __init__(self, model):
        self.module = model
        self.init = _JITTED.setdefault(("init", model), jax.jit(model.init))

    def __getattr__(self, name):
        return getattr(self.module, name)


def _build_model(cfg):
    model = _real_build_model(cfg)
    return _JitInit(model) if isinstance(cfg, JViTConfig) else model


def _feature_step(model):
    model = model.module
    return _JITTED.setdefault(("features", model), _real_feature_step(model))


def _log(work):
    with open(os.path.join(work, "checkpoints", "log.txt")) as f:
        return [json.loads(line) for line in f]


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("dataset", ["brats", "egd"])
def test_pretrain_kfold_matches_jax(dataset, brats_dir, egd_dir, tmp_path, monkeypatch):
    base = brats_dir if dataset == "brats" else egd_dir
    dkw = dict(name=dataset, base_path=base, volume_size=16, in_channels=1, use_z_score=True)
    if dataset == "egd":
        dkw.update(volume_size=12, in_channels=4)
    tkw = dict(epochs=2, batch_size=BATCH, patch_size=PATCH, warmup_epochs=1,
               compute_dtype="float32", contr_weight=0.001)
    rng = np.random.default_rng(17)
    n_patches = (dkw["volume_size"] // PATCH) ** 3
    noises = [rng.random((2 * BATCH, n_patches)).astype(np.float32) for _ in range(FOLDS)]

    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    want, jrec = _run(jpk, jt, JDataConfig(**dkw), JTrainConfig(**tkw), jwork, noises, monkeypatch)
    got, trec = _run(tpk, tt, DataConfig(**dkw), TrainConfig(**tkw), twork, noises, monkeypatch,
                     jax_init=jrec["init"])

    assert set(got) == set(want) == set(range(FOLDS))
    for fold in range(FOLDS):
        assert _rel(got[fold]["min_loss"], want[fold]["min_loss"]) <= LOSS_RTOL, fold
        np.testing.assert_array_equal(trec["ids"][fold], jrec["ids"][fold])
    if dataset == "egd":  # labeled-train plus the SSL pool's offset ids (4 and 5)
        assert all(set(ids) >= {4, 5} and len(ids) == 4 for ids in trec["ids"].values())

    split_dir = os.path.join("k_fold", "indices_file")
    assert sorted(os.listdir(os.path.join(twork, split_dir))) == sorted(os.listdir(os.path.join(jwork, split_dir)))
    for name in os.listdir(os.path.join(jwork, split_dir)):
        np.testing.assert_array_equal(np.load(os.path.join(twork, split_dir, name)),
                                      np.load(os.path.join(jwork, split_dir, name)))

    jlog, tlog = _log(jwork), _log(twork)
    assert [(r["fold"], r["epoch"]) for r in tlog] == [(r["fold"], r["epoch"]) for r in jlog]
    assert [list(r) for r in tlog] == [list(r) for r in jlog]
    for t, j in zip(tlog, jlog):
        for key in ("train_loss", "train_reconstruction_loss", "train_edge_map_loss"):
            assert _rel(t[key], j[key]) <= LOSS_RTOL, (key, t, j)
        assert _rel(t["train_lr"], j["train_lr"]) <= LR_RTOL, (t, j)

    for fold in range(FOLDS):
        for tag in ("train", "test"):
            stem = os.path.join("ssl_features_dir", f"{tag}_contrast_ssl_%s_split_{fold}.npy")
            np.testing.assert_array_equal(np.load(os.path.join(twork, stem % "labels")),
                                          np.load(os.path.join(jwork, stem % "labels")))
            tf, jf = np.load(os.path.join(twork, stem % "features")), np.load(os.path.join(jwork, stem % "features"))
            assert tf.dtype == np.float32 and tf.shape == jf.shape and tf.shape[1] == 24
            err = np.abs(tf - jf).max() / np.abs(jf).max()
            assert err <= FEAT_TOL, (fold, tag, err)
