"""The port's downstream pipelines against the JAX package's, on the CPU, at
the tiny preset (16^3, patch 4, width 24, depth 2, f32, batch 4):

- `extract_ssl_features` from the same MAE weights (an orbax directory for
  the JAX package, the `.pth` for the port): features within 1e-4 of the
  largest reference feature, labels equal;
- `probe_kfold` as the probe (frozen backbone, SGD) and as the k-fold
  fine-tune (layer-wise AdamW), and `finetune_single`: 2 folds, 2 epochs, no
  mixup, the scipy augmentation policy in both pipeline namespaces (items
  bitwise equal, tests/test_torch_port_data.py), the head drawn by the JAX
  package injected into the port. Every log row's losses within 1e-4
  relative and its AUC, specificity and sensitivity within 1e-6; the test
  results of each best model the same; the best-checkpoint names the same
  (orbax directories there, `.pth` files here);
- `eval_only` on a finished work dir reads the trained run's test results
  and adds no log row;
- a k-fold fine-tune with MixUp3D killed after epoch 0's resume checkpoint
  and resumed equals the uninterrupted run bitwise (transform-free: both
  packages restart augmentation streams with the process);
- the four CLI subcommands on the CPU, and their refusals.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import MAEConfig as JMAEConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.configs import ViTConfig as JViTConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.models import MaskedAutoencoderViT3D as JMAE
from vit_ae_plus_plus_tpu.models import build_model as _real_build_model
from vit_ae_plus_plus_tpu.pipelines import extract_features as jef
from vit_ae_plus_plus_tpu.pipelines import finetune as jft
from vit_ae_plus_plus_tpu.pipelines import probe_kfold as jpk
from vit_ae_plus_plus_tpu.train.checkpoint import save_params
from vit_ae_plus_plus_torch.cli import main as cli_main
from vit_ae_plus_plus_torch.cli import run as cli_run
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.pipelines import extract_features as tef
from vit_ae_plus_plus_torch.pipelines import finetune as tft
from vit_ae_plus_plus_torch.pipelines import probe_kfold as tpk
from vit_ae_plus_plus_torch.train.checkpoint import load_reference_state_dict, params_from_jax, save_state_dict

MODEL, VOL, PATCH, BATCH, FOLDS, EPOCHS = "contr_mae_vit_tiny_patch4", 16, 4, 4, 2, 2
FEAT_TOL, LOSS_RTOL, METRIC_TOL = 1e-4, 1e-4, 1e-6
METRICS = ("roc_auc_score", "specificity", "sensitivity")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """24 volumes for the k folds (`whole`), and train / val / test splits of
    12 / 4 / 4 for the single-run fine-tune and the extraction."""
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    for mode, n in (("whole", 24), ("train", 12), ("val", 4), ("test", 4)):
        np.save(root / f"x_{mode}_ssl.npy", rng.standard_normal((n, VOL, VOL, VOL, 1)).astype(np.float32))
        np.save(root / f"y_{mode}_ssl.npy", np.array([0, 1] * (n // 2)))
    return str(root)


@pytest.fixture(scope="module")
def pretrain_dir(tmp_path_factory):
    """One MAE per fold (JAX's init from PRNGKey(fold), jitted), written as
    the JAX package's orbax `checkpoint-min_loss` and the port's
    `checkpoint-min_loss.pth` beside it."""
    root = tmp_path_factory.mktemp("pretrain")
    model = JMAE(JMAEConfig(volume_size=VOL, patch_size=PATCH, embed_dim=24, depth=2, num_heads=3,
                            decoder_embed_dim=12, decoder_depth=1, decoder_num_heads=2, contrastive=True))
    sample = jnp.zeros((1, 1, VOL, VOL, VOL), jnp.float32)
    init = jax.jit(model.init)
    for fold in range(FOLDS):
        variables = jax.tree.map(np.asarray, init({"params": jax.random.PRNGKey(fold),
                                                   "mask": jax.random.PRNGKey(9)}, sample, sample))
        d = root / "checkpoints" / f"fold_{fold}"
        d.mkdir(parents=True)
        save_params(str(d / "checkpoint-min_loss"), variables["params"])
        save_state_dict(str(d / "checkpoint-min_loss.pth"),
                        params_from_jax(variables["params"], PATCH, 1, variables["batch_stats"]))
    return str(root)


# JAX's `init` of the classifier ViT, compiled once and reused by every fold
# and run (flax runs `init` op by op, which took most of the JAX side's time)
_JITTED = {}


class _JitInit:
    def __init__(self, model):
        self.module = model
        self.init = _JITTED.setdefault(("init", model), jax.jit(model.init))

    def __getattr__(self, name):
        return getattr(self.module, name)


def _build_model(cfg):
    model = _real_build_model(cfg)
    return _JitInit(model) if isinstance(cfg, JViTConfig) else model


def _shared_eval_step(real):
    """JAX's `make_supervised_steps`, its jitted eval step (a function of
    the params, batch and labels alone) compiled once per model and reused
    by every fold and run, where the pipeline compiles one a fold."""

    def make_supervised_steps(model, **kwargs):
        train_step, eval_step = real(model, **kwargs)
        key = ("eval", getattr(model, "module", model), kwargs.get("num_classes"))
        return train_step, _JITTED.setdefault(key, eval_step)

    return make_supervised_steps


def _configs(data_dir, **train):
    dkw = dict(name="brats", base_path=data_dir, volume_size=VOL, in_channels=1, use_z_score=True)
    tkw = {**dict(epochs=EPOCHS, batch_size=BATCH, patch_size=PATCH, warmup_epochs=1, lr=1e-3,
                  compute_dtype="float32"), **train}
    return (JDataConfig(**dkw), JTrainConfig(**tkw)), (DataConfig(**dkw), TrainConfig(**tkw))


def _jax_namespace(monkeypatch, module, heads):
    """The JAX pipeline module with the scipy policy, the jitted ViT init and
    its head draws recorded in `heads`."""
    monkeypatch.setattr(module, "default_ssl_transforms",
                        lambda: jt.default_ssl_transforms(native="never"), raising=False)
    real_head = jft.head_init_2e5

    def head_init_2e5(params, rng):
        params = real_head(params, rng)
        heads.append(jax.tree.map(np.asarray, params["head"]))
        return params

    monkeypatch.setattr(module, "head_init_2e5", head_init_2e5)
    monkeypatch.setattr(module, "build_model", _build_model, raising=False)
    monkeypatch.setattr(module, "make_supervised_steps", _shared_eval_step(jft.make_supervised_steps))
    monkeypatch.setattr(jft, "head_init_2e5", head_init_2e5)


def _port_namespace(monkeypatch, heads, transforms=True):
    """The port's pipelines with the scipy policy (or none) and the JAX
    package's heads loaded in turn."""
    policy = (lambda: tt.default_ssl_transforms(native="never")) if transforms else (lambda: None)
    monkeypatch.setattr(tpk, "default_ssl_transforms", policy)
    monkeypatch.setattr(tft, "default_ssl_transforms", policy)
    drawn = []

    def head_init_2e5(model, _generator):
        head = heads[len(drawn) % len(heads)]  # JAX draws one per fold, in order
        drawn.append(head)
        with torch.no_grad():
            model.head.weight.copy_(torch.from_numpy(np.array(head["kernel"].T)))
            model.head.bias.copy_(torch.from_numpy(np.array(head["bias"])))

    if heads is not None:
        monkeypatch.setattr(tft, "head_init_2e5", head_init_2e5)


def _log(work):
    with open(os.path.join(work, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _check_stats(got, want, where):
    assert set(got) == set(want), where
    for k, w in want.items():
        g = got[k]
        if k.endswith("loss"):
            assert abs(g - w) <= LOSS_RTOL * abs(w), (where, k, g, w)
        elif isinstance(w, float) and k.endswith(METRICS):
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= METRIC_TOL, (where, k, g, w)
        else:
            assert g == w, (where, k, g, w)


def _best_names(work):
    return sorted(n[:-len(".pth")] if n.endswith(".pth") else n
                  for n in os.listdir(os.path.join(work, "checkpoints")) if n.startswith("checkpoint-"))


def test_extract_features_matches_jax(data_dir, pretrain_dir, tmp_path, monkeypatch):
    (jd, _), (td, _) = _configs(data_dir)
    monkeypatch.setattr(jef, "build_model", _build_model)
    ckpt = os.path.join(pretrain_dir, "checkpoints", "fold_0", "checkpoint-min_loss")
    kw = dict(model_name=MODEL, batch_size=BATCH, patch_size=PATCH, compute_dtype="float32")
    jef.extract_ssl_features(jd, ckpt, str(tmp_path / "jax"), **kw)
    tef.extract_ssl_features(td, ckpt + ".pth", str(tmp_path / "port"), device="cpu", **kw)
    for split, n in (("train", 12), ("test", 4)):
        want = np.load(tmp_path / "jax" / f"{split}_features.npy")
        got = np.load(tmp_path / "port" / f"{split}_features.npy")
        assert got.dtype == np.float32 and got.shape == want.shape == (n, 24)
        assert np.abs(got - want).max() <= FEAT_TOL * np.abs(want).max()
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{split}_gt_labels.npy"),
                                      np.load(tmp_path / "jax" / f"{split}_gt_labels.npy"))
    with pytest.raises(ValueError, match="only_test_split"):
        tef.extract_ssl_features(DataConfig(name="egd"), ckpt + ".pth", str(tmp_path / "egd"), device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        tef.extract_ssl_features(td, ckpt + ".pth", str(tmp_path / "q"), quantize="int4", device="cpu")
    assert not (tmp_path / "egd").exists() and not (tmp_path / "q").exists()
    # the int8 engine: the JAX package's int8 extraction's features within
    # 1e-3 of the largest (tests/test_torch_port_quant.py's bar)
    jef.extract_ssl_features(jd, ckpt, str(tmp_path / "jax_q"), quantize="int8", **kw)
    tef.extract_ssl_features(td, ckpt + ".pth", str(tmp_path / "q"), quantize="int8", device="cpu", **kw)
    for split in ("train", "test"):
        want = np.load(tmp_path / "jax_q" / f"{split}_features.npy")
        got = np.load(tmp_path / "q" / f"{split}_features.npy")
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["probe", "finetune_kfold", "finetune_single", "probe_accum",
                                  "finetune_single_accum"])
def test_downstream_matches_jax(mode, data_dir, pretrain_dir, tmp_path, monkeypatch):
    """`_accum`: `accum_iter=2` without `lr`, so the rate is blr * batch *
    2 / 256 in both packages (`train_lr` in each log row, held with the
    other metrics), and no optimizer accumulates."""
    accum = mode.endswith("_accum")
    mode = mode.removesuffix("_accum")
    (jd, jtc), (td, ttc) = _configs(data_dir, **(dict(accum_iter=2, lr=None) if accum else {}))
    rates = {"jax": [], "port": []}
    if accum:  # the base rate each fold's schedule is built with
        from vit_ae_plus_plus_tpu import train as jtrain

        for side, module, name in (("jax", jtrain, "warmup_cosine_schedule"), ("jax", jpk, "warmup_cosine_schedule"),
                                   ("port", tft, "warmup_cosine_schedule"), ("port", tpk, "warmup_cosine_schedule")):
            real = getattr(module, name)
            monkeypatch.setattr(module, name, lambda lr, *a, _real=real, _side=side: rates[_side].append(lr)
                                or _real(lr, *a))
    heads = []
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    if mode == "finetune_single":
        ckpt = os.path.join(pretrain_dir, "checkpoints", "fold_1", "checkpoint-min_loss")
        _jax_namespace(monkeypatch, jft, heads)
        monkeypatch.setattr(jft, "_mae_params_template", jpk._mae_params_template, raising=False)
        monkeypatch.setattr("vit_ae_plus_plus_tpu.data.default_ssl_transforms",
                            lambda: jt.default_ssl_transforms(native="never"))
        monkeypatch.setattr("vit_ae_plus_plus_tpu.models.build_model", _build_model)
        want = jft.finetune_single(jd, jtc, jwork, ckpt, model_name=MODEL)
        _port_namespace(monkeypatch, heads)
        got = tft.finetune_single(td, ttc, twork, ckpt + ".pth", model_name=MODEL, device="cpu")
        want, got = {0: want}, {0: got}
    else:
        fix = mode == "probe"
        _jax_namespace(monkeypatch, jpk, heads)
        want = jpk.probe_kfold(jd, jtc, jwork, pretrain_dir, model_name=MODEL, n_splits=FOLDS, fix_backbone=fix)
        _port_namespace(monkeypatch, heads)
        got = tpk.probe_kfold(td, ttc, twork, pretrain_dir, model_name=MODEL, n_splits=FOLDS,
                              fix_backbone=fix, device="cpu")
        for name in os.listdir(os.path.join(jwork, "k_fold", "indices_file")):
            np.testing.assert_array_equal(np.load(os.path.join(twork, "k_fold", "indices_file", name)),
                                          np.load(os.path.join(jwork, "k_fold", "indices_file", name)))
    assert len(heads) == len(want)
    if accum:  # blr * batch * accum_iter / 256, fold by fold
        assert rates["port"] == rates["jax"] == [1e-3 * BATCH * 2 / 256] * len(want)
    jlog, tlog = _log(jwork), _log(twork)
    assert [list(r) for r in tlog] == [list(r) for r in jlog] and len(tlog) == len(want) * EPOCHS
    for i, (t, j) in enumerate(zip(tlog, jlog)):
        _check_stats(t, j, f"{mode} log row {i}")
    assert set(got) == set(want)
    for fold in want:
        assert set(got[fold]) == set(want[fold]) and want[fold], (fold, got[fold], want[fold])
        for name in want[fold]:
            _check_stats(got[fold][name], want[fold][name], f"{mode} fold {fold} {name}")
    assert _best_names(twork) == _best_names(jwork)
    if mode == "probe":  # eval_only reads the saved best models again, and trains nothing
        again = tpk.probe_kfold(td, ttc, twork, pretrain_dir, model_name=MODEL, n_splits=FOLDS,
                                fix_backbone=True, eval_only=True, device="cpu")
        assert again == got and _log(twork) == tlog


class _Killed(Exception):
    pass


def test_resume_after_epoch_0_equals_the_uninterrupted_run(data_dir, pretrain_dir, tmp_path, monkeypatch):
    _, (td, ttc) = _configs(data_dir, resume=True)
    _port_namespace(monkeypatch, None, transforms=False)
    kw = dict(model_name=MODEL, n_splits=FOLDS, fix_backbone=False, use_mixup=True, device="cpu")
    full_dir, cut_dir = str(tmp_path / "full"), str(tmp_path / "cut")
    full = tpk.probe_kfold(td, ttc, full_dir, pretrain_dir, **kw)

    real_save = tpk.save_atomic

    def save_then_die(obj, path):
        real_save(obj, path)
        raise _Killed(path)

    monkeypatch.setattr(tpk, "save_atomic", save_then_die)
    with pytest.raises(_Killed):
        tpk.probe_kfold(td, ttc, cut_dir, pretrain_dir, **kw)
    assert len(_log(cut_dir)) == 1
    monkeypatch.setattr(tpk, "save_atomic", real_save)
    resumed = tpk.probe_kfold(td, ttc, cut_dir, pretrain_dir, **kw)
    assert resumed == full
    assert _log(cut_dir) == _log(full_dir)
    assert _best_names(cut_dir) == _best_names(full_dir)
    for name in os.listdir(os.path.join(full_dir, "checkpoints")):
        a = torch.load(os.path.join(full_dir, "checkpoints", name), weights_only=True)
        b = torch.load(os.path.join(cut_dir, "checkpoints", name), weights_only=True)
        flat = {k: v for k, v in a.items()} if "model" not in a else a["model"]
        other = {k: v for k, v in b.items()} if "model" not in b else b["model"]
        assert all(torch.equal(flat[k], other[k]) for k in flat), name


def _argv(cmd, data_dir, work, *extra):
    return [cmd, "--device", "cpu", "--data-path", data_dir, "--work-dir", work, "--model", MODEL,
            "--volume-size", str(VOL), "--patch-size", str(PATCH), "--batch-size", str(BATCH),
            "--epochs", "1", "--n-splits", str(FOLDS), "--compute-dtype", "float32", *extra]


def test_cli_subcommands(data_dir, pretrain_dir, tmp_path, capsys):
    ckpt = os.path.join(pretrain_dir, "checkpoints", "fold_0", "checkpoint-min_loss.pth")
    assert cli_main(_argv("extract-features", data_dir, str(tmp_path / "feats"), "--checkpoint", ckpt)) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == "done"
    assert sorted(os.listdir(tmp_path / "feats")) == ["test_features.npy", "test_gt_labels.npy",
                                                     "train_features.npy", "train_gt_labels.npy"]
    for cmd, extra in (("probe-kfold", ["--pretrain-dir", pretrain_dir, "--use-mixup"]),
                       ("finetune-kfold", ["--pretrain-dir", pretrain_dir]),
                       ("finetune", ["--checkpoint", ckpt, "--fix-backbone"])):
        work = str(tmp_path / cmd)
        assert cli_main(_argv(cmd, data_dir, work, *extra)) == 0, cmd
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        folds = out.values() if cmd != "finetune" else [out]
        assert len(folds) == (FOLDS if cmd != "finetune" else 1) and all(folds), (cmd, out)
        for result in folds:
            for stats in result.values():
                assert all(np.isfinite(stats[k]) for k in ("roc_auc_score", "loss")), (cmd, stats)
        for name in _best_names(work):
            assert load_reference_state_dict(os.path.join(work, "checkpoints", name + ".pth"))["head.weight"].shape == (2, 24)
        rows = _log(work)
        assert len(rows) == (FOLDS if cmd != "finetune" else 1), (cmd, rows)
        if cmd == "finetune":  # the frozen backbone counts the head only
            assert rows[0]["n_parameters"] == 24 * 2 + 2


@pytest.mark.parametrize("cmd", ["extract-features", "probe-kfold", "finetune-kfold", "finetune"])
def test_cli_refusals(cmd, tmp_path, capsys, monkeypatch):
    extra = {"extract-features": ["--checkpoint", "none.pth"], "finetune": ["--checkpoint", "none.pth"]}.get(
        cmd, ["--pretrain-dir", str(tmp_path / "none")])
    work = tmp_path / "w"
    argv = _argv(cmd, str(tmp_path / "no_data"), str(work), *extra)
    assert cli_run(argv + ["--n-devices", "3"]) == 2  # the batch of 4 does not split in 3
    assert "does not split into 3" in capsys.readouterr().err
    assert not work.exists()  # before any spawn
    if cmd == "extract-features":
        assert cli_run(argv + ["--quantize", "int8"]) == 2  # int8 runs: the missing checkpoint stops it
        assert "none.pth" in capsys.readouterr().err
        assert cli_run(argv[:1] + ["--dataset", "egd"] + argv[1:]) == 2
        assert "only-test-split" in capsys.readouterr().err
        assert not work.exists()
    else:
        # n_devices > 1 in a process that is not one of so many ranks
        _, (td, ttc) = _configs(str(tmp_path / "no_data"))
        with pytest.raises(ValueError, match="n_devices=2 trains on 2 ranks"):
            if cmd == "finetune":
                tft.finetune_single(td, ttc, str(work), "none.pth", n_devices=2, device="cpu")
            else:
                tpk.probe_kfold(td, ttc, str(work), "none", fix_backbone=cmd == "probe-kfold", n_devices=2,
                                device="cpu")
        assert os.listdir(work) == [".writer.lock"]  # refused after the lock, before any data
    # accum_iter > 1 only scales the rate, as in the JAX package: not
    # refused, so the missing data stops the run
    _, (td, ttc) = _configs(str(tmp_path / "no_data"), accum_iter=2)
    with pytest.raises(FileNotFoundError):
        if cmd == "finetune":
            tft.finetune_single(td, ttc, str(tmp_path / "a"), "none.pth", device="cpu")
        else:
            tpk.probe_kfold(td, ttc, str(tmp_path / "a"), "none", fix_backbone=cmd == "probe-kfold", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(argv[:1] + argv[3:])  # without --device cpu
