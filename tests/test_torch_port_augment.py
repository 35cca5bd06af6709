"""The port's augmentation on the card (ops/augment.py), its resident batch
source (`DeviceResidentBatches`) and `pretrain_kfold` with `device_data` and
`device_augment`, against the JAX package on the CPU.

The random streams differ (JAX keys, torch generators), so every function
is held to JAX's with JAX's own draws injected: `_jax_draws` derives them
from a key exactly as the JAX functions do (per volume: split into affine,
noise and gamma keys; the affine key into scale and angles, the noise key
into sigma and field), compiled once per shape.

Tolerances: f32 on both sides in another summation order, so every
function within 1e-5 of the largest reference magnitude (the band weights
and passes are products and sums of a few terms; the twelve contractions
of the shear each sum at most two taps). The shear against the exact
gather sampler is held to the JAX package's own bounds
(tests/test_device_augment.py: an interior error below 0.02 and a
correlation above 0.995 on a smooth volume, 1e-4 for a pure rescale).
`pretrain_kfold` with both options runs through the harness of
tests/test_torch_port_pretrain_kfold.py with JAX's initial weights, noise
and augmentation draws injected, on its gates (log rows' losses 1e-4
relative, lr 1e-6, features 1e-3 of the largest).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.configs import TrainConfig as JTrainConfig
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.data.loader import DeviceResidentBatches as JDeviceResidentBatches
from vit_ae_plus_plus_tpu.ops import augment as ja
from vit_ae_plus_plus_tpu.pipelines import pretrain_kfold as jpk
from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
from vit_ae_plus_plus_torch.data import BraTSDataset, Loader
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.data.loader import DeviceResidentBatches
from vit_ae_plus_plus_torch.ops import augment as ta
from vit_ae_plus_plus_torch.pipelines import pretrain_kfold as tpk

from test_torch_port_pretrain_kfold import FEAT_TOL, FOLDS, LOSS_RTOL, LR_RTOL, _log, _rel, _run, brats_dir, egd_dir  # noqa: F401

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


_DRAWS = {}


def _jax_draws_fn(shape):
    def one(key):
        k1, k2, k3 = jax.random.split(key, 3)
        ka, kb = jax.random.split(k1)
        scale = jax.random.uniform(ka, (3,), minval=1 - 0.1, maxval=1 + 0.1)
        angles = jax.random.uniform(kb, (3,), minval=-10.0, maxval=10.0) * (math.pi / 180.0)
        ka, kb = jax.random.split(k2)
        sigma = jax.random.uniform(ka, (), minval=0.0, maxval=0.1)
        field = jax.random.normal(kb, shape, jnp.float32)
        gamma = jnp.exp(jax.random.uniform(k3, (), minval=-0.3, maxval=0.3))
        return {"scale": scale, "angles": angles, "sigma": sigma, "field": field, "gamma": gamma}

    return jax.jit(jax.vmap(one))


def _jax_draws(key, shape):
    """The draws the JAX package's `device_augment_batch(key, raw)` makes
    for a raw batch of `shape`, by volume, as torch tensors."""
    fn = _DRAWS.setdefault(tuple(shape[1:]), _jax_draws_fn(tuple(shape[1:])))
    return {k: torch.from_numpy(np.array(v)) for k, v in fn(jax.random.split(key, shape[0])).items()}


def test_trilinear_sample_and_rotation_match_jax():
    vol = _np((2, 16, 16, 16), 0)
    coords = np.random.default_rng(1).uniform(-2, 17, (3, 3000)).astype(np.float32)
    coords[:, :100] = np.round(coords[:, :100])  # grid points
    _close(ta.trilinear_sample(torch.from_numpy(vol), torch.from_numpy(coords)),
           ja.trilinear_sample(jnp.asarray(vol), jnp.asarray(coords)))
    angles = np.array([0.1, -0.15, 0.17], np.float32)
    _close(ta._rotation_matrix(torch.from_numpy(angles)), ja._rotation_matrix(jnp.asarray(angles)))


@pytest.mark.parametrize("moved,other", [(0, 1), (0, 2), (1, 0), (1, 2), (2, 0), (2, 1), (0, None), (1, None),
                                         (2, None)])
def test_band_weights_and_each_pass_match_jax(moved, other):
    vol = _np((2, 16, 18, 20), 2)
    center = (np.asarray(vol.shape[1:], np.float32) - 1) / 2
    coef = np.float32(0.93 if other is None else -0.087)
    alpha, beta = (coef, None) if other is None else (None, coef)
    want = ja._apply_shear(jnp.asarray(vol), moved, other, alpha, beta, jnp.asarray(center))
    t = (lambda x: None if x is None else torch.tensor(x))
    got = ta._apply_shear(torch.from_numpy(vol), moved, other, t(alpha), t(beta), torch.from_numpy(center))
    _close(got, want)
    pos = np.random.default_rng(3).uniform(-2, 19, (5, 16)).astype(np.float32)
    np.testing.assert_array_equal(ta._band_weights(torch.from_numpy(pos), 17).numpy(),
                                  np.asarray(ja._band_weights(jnp.asarray(pos), 17)))
    for axis in range(3):
        theta = np.float32(0.12 * (axis + 1))
        for (m, o, b), (jm, jo, jb) in zip(ta._paeth_passes(axis, torch.tensor(theta)),
                                           ja._paeth_passes(axis, jnp.asarray(theta))):
            assert (m, o) == (jm, jo)
            _close(b, jb)


@pytest.mark.parametrize("method", ["shear", "gather"])
def test_random_affine_with_jax_draws_matches_jax(method):
    vol = _np((2, 24, 24, 24), 4)
    key = jax.random.PRNGKey(5)
    want = ja.random_affine_3d(key, jnp.asarray(vol), method=method)
    ka, kb = jax.random.split(key)
    scale = np.array(jax.random.uniform(ka, (3,), minval=0.9, maxval=1.1))
    angles = np.array(jax.random.uniform(kb, (3,), minval=-10.0, maxval=10.0) * (math.pi / 180.0))
    got = ta.random_affine_3d(torch.from_numpy(vol), torch.from_numpy(scale), torch.from_numpy(angles), method)
    _close(got, want)


def test_noise_and_gamma_with_jax_draws_match_jax():
    vol = _np((1, 16, 16, 16), 6) * 3 + 2
    key = jax.random.PRNGKey(7)
    ka, kb = jax.random.split(key)
    sigma = np.asarray(jax.random.uniform(ka, (), minval=0.0, maxval=0.1))
    field = np.asarray(jax.random.normal(kb, vol.shape, jnp.float32))
    _close(ta.random_noise(torch.from_numpy(vol), torch.tensor(sigma), torch.from_numpy(field)),
           ja.random_noise(key, jnp.asarray(vol)))
    gamma = np.asarray(jnp.exp(jax.random.uniform(key, (), minval=-0.3, maxval=0.3)))
    _close(ta.random_gamma(torch.from_numpy(vol), torch.tensor(gamma)), ja.random_gamma(key, jnp.asarray(vol)))


@pytest.mark.parametrize("name", ["znorm_volume", "minmax_volume", "znorm_per_channel"])
def test_normalisations_match_jax(name):
    vol = _np((3, 12, 12, 12), 8) * np.array([1.0, 5.0, 0.2], np.float32)[:, None, None, None] + 7
    _close(getattr(ta, name)(torch.from_numpy(vol)), getattr(ja, name)(jnp.asarray(vol)))


@pytest.mark.parametrize("case", ["brats", "egd", "minmax"])
def test_device_augment_batch_with_jax_draws_matches_jax(case):
    c, z, per_channel = {"brats": (1, True, False), "egd": (4, True, True), "minmax": (1, False, False)}[case]
    raw = _np((2, c, 12, 12, 12), 9) * 3 + 5
    key = jax.random.PRNGKey(10)
    want = ja.device_augment_batch(key, jnp.asarray(raw), z, per_channel=per_channel)
    got = ta.device_augment_batch(torch.from_numpy(raw), use_z_score=z, per_channel=per_channel,
                                  draws=_jax_draws(key, raw.shape))
    for g, w in zip(got, want):
        _close(g, w)


def test_shear_stays_within_the_jax_bounds_of_the_gather():
    """The JAX package's bounds for its shear against its exact sampler
    (tests/test_device_augment.py), held by the port's two paths."""
    rng = np.random.default_rng(2)
    vol = torch.from_numpy(rng.standard_normal((2, 10, 10, 10)).astype(np.float32))
    assert torch.equal(ta._affine_shear(vol, torch.zeros(3), torch.ones(3)), vol)
    xs = np.linspace(-1, 1, 24)
    g = np.exp(-(xs[:, None, None] ** 2 + xs[None, :, None] ** 2 + xs[None, None, :] ** 2) * 3).astype(np.float32)
    vol = torch.from_numpy(g[None])
    angles = torch.from_numpy(np.array([7.0, -5.0, 9.0], np.float32) * np.float32(np.pi / 180.0))
    scale = torch.tensor([0.95, 1.05, 1.0])
    exact, shear = ta._affine_gather(vol, angles, scale).numpy(), ta._affine_shear(vol, angles, scale).numpy()
    sl = (slice(None), slice(3, -3), slice(3, -3), slice(3, -3))
    assert np.abs(exact[sl] - shear[sl]).max() < 0.02
    assert np.corrcoef(exact.ravel(), shear.ravel())[0, 1] > 0.995
    vol = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 12, 12, 12)).astype(np.float32))
    scale = torch.tensor([0.92, 1.08, 1.03])
    exact, shear = ta._affine_gather(vol, torch.zeros(3), scale), ta._affine_shear(vol, torch.zeros(3), scale)
    sl = (slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
    np.testing.assert_allclose(shear[sl].numpy(), exact[sl].numpy(), rtol=1e-4, atol=1e-4)


def test_a_rank_applies_its_rows_of_the_global_batch_draws():
    """rows=(d, D): the global batch's draws, rank d's rows of them, so the
    ranks' views are the one-process views' rows; drawn for the rank's rows
    alone they are not (tests/test_torch_port_ring_flash.py holds the same
    on ranks of a gloo group)."""
    raw = _np((4, 1, 12, 12, 12), 11) + 3
    gen = torch.Generator()
    whole = ta.device_augment_batch(torch.from_numpy(raw), gen.manual_seed(3))
    for d in range(2):
        part = ta.device_augment_batch(torch.from_numpy(raw[2 * d:2 * d + 2]), gen.manual_seed(3), rows=(d, 2))
        for p, w in zip(part, whole):
            torch.testing.assert_close(p, w[2 * d:2 * d + 2], rtol=0, atol=0)
    local = ta.device_augment_batch(torch.from_numpy(raw[2:]), gen.manual_seed(3))
    assert not torch.allclose(local[0], whole[0][2:], atol=1e-3)


@pytest.mark.parametrize("shard", [None, (0, 2), (1, 2)])
def test_device_resident_batches_follow_the_loader(brats_dir, shard):
    """The epoch order is `Loader`'s over three epochs (and JAX's
    `DeviceResidentBatches`'), each rank its rows of each global batch;
    `set_epoch` replays an epoch; only raw datasets are staged."""
    ids = np.array([3, 1, 4, 15, 9, 2, 6, 5, 8, 13])
    raw = BraTSDataset(brats_dir, "whole", raw=True)
    resident = DeviceResidentBatches(raw, 4, indices=ids, seed=7, device="cpu", shard_rows=shard)
    loader = Loader(raw, 4, indices=ids, seed=7, num_workers=1, shard_rows=shard)
    want_jax = JDeviceResidentBatches(raw, 4, indices=ids, seed=7)
    assert len(resident) == len(loader) == 2 and resident.nbytes() == 10 * 16**3 * 4
    for _ in range(3):
        for (a, b, lab), (la, _, llab), (ja_, _, _) in zip(resident, loader, want_jax):
            assert a is b and a.shape[0] == (4 if shard is None else 2)
            np.testing.assert_array_equal(a.numpy(), la)
            np.testing.assert_array_equal(lab, llab)
            if shard is None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(ja_))
    resident.set_epoch(1)
    loader.set_epoch(1)
    np.testing.assert_array_equal(next(iter(resident))[0].numpy(), next(iter(loader))[0])
    with pytest.raises(ValueError, match="raw=True"):
        DeviceResidentBatches(BraTSDataset(brats_dir, "whole"), 4, device="cpu")


def _jax_augment_draws(monkeypatch, seed, steps_per_epoch, rec):
    """The port's `device_augment_batch` in `pretrain_kfold` with the draws
    the JAX pipeline makes at the same fold, epoch and step:
    fold_in(fold_in(PRNGKey(seed + 100 + fold), epoch), step)."""
    real, calls = tpk.device_augment_batch, {}

    def device_augment_batch(raw, generator, use_z_score, per_channel, rows=None):
        fold = rec["fold"]
        n = calls[fold] = calls.get(fold, -1) + 1
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed + 100 + fold),
                                                    n // steps_per_epoch), n % steps_per_epoch)
        return real(raw, use_z_score=use_z_score, per_channel=per_channel, draws=_jax_draws(key, raw.shape))

    monkeypatch.setattr(tpk, "device_augment_batch", device_augment_batch)
    return calls


@pytest.mark.parametrize("dataset", ["brats", "egd"])
def test_pretrain_kfold_on_resident_data_matches_jax(dataset, brats_dir, egd_dir, tmp_path, monkeypatch):
    base = brats_dir if dataset == "brats" else egd_dir
    dkw = dict(name=dataset, base_path=base, volume_size=16, in_channels=1, use_z_score=True)
    if dataset == "egd":
        dkw.update(volume_size=12, in_channels=4)
    tkw = dict(epochs=2, batch_size=4, patch_size=4, warmup_epochs=1, compute_dtype="float32", contr_weight=0.001,
               device_augment=True, device_data=True)
    rng = np.random.default_rng(17)
    noises = [rng.random((8, (dkw["volume_size"] // 4) ** 3)).astype(np.float32) for _ in range(FOLDS)]
    jwork, twork = str(tmp_path / "jax"), str(tmp_path / "port")
    _, jrec = _run(jpk, jt, JDataConfig(**dkw), JTrainConfig(**tkw), jwork, noises, monkeypatch)
    rec = {}
    real_fold = tpk.pretrain_one_fold

    def pretrain_one_fold(fold_idx, *args, **kwargs):
        rec["fold"] = fold_idx
        return real_fold(fold_idx, *args, **kwargs)

    monkeypatch.setattr(tpk, "pretrain_one_fold", pretrain_one_fold)
    calls = _jax_augment_draws(monkeypatch, 42, 2 if dataset == "brats" else 1, rec)
    _run(tpk, tt, DataConfig(**dkw), TrainConfig(**tkw), twork, noises, monkeypatch, jax_init=jrec["init"])
    assert calls == {k: 3 if dataset == "brats" else 1 for k in range(FOLDS)}

    jlog, tlog = _log(jwork), _log(twork)
    assert [list(r) for r in tlog] == [list(r) for r in jlog] and len(tlog) == 2 * FOLDS
    for t, j in zip(tlog, jlog):
        for key in ("train_loss", "train_reconstruction_loss", "train_edge_map_loss"):
            assert _rel(t[key], j[key]) <= LOSS_RTOL, (key, t, j)
        assert _rel(t["train_lr"], j["train_lr"]) <= LR_RTOL
    for fold in range(FOLDS):
        for tag in ("train", "test"):
            name = f"ssl_features_dir/{tag}_contrast_ssl_features_split_{fold}.npy"
            tf, jf = np.load(f"{twork}/{name}"), np.load(f"{jwork}/{name}")
            assert np.abs(tf - jf).max() <= FEAT_TOL * np.abs(jf).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lbp_histogram_equals_jax(dtype):
    """The per-slice LBP codes' histogram (ops/lbp.py), equal to the JAX
    package's: the codes are integers from the same rolled, bilinearly
    weighted neighbours."""
    from vit_ae_plus_plus_tpu.ops.lbp import lbp_histogram as jax_lbp_histogram
    from vit_ae_plus_plus_torch.ops.lbp import lbp_histogram

    vol = np.random.default_rng(12).standard_normal((6, 20, 24)).astype(dtype)
    vol[:, :4, :4] = 1.0  # flat patches: ties with the neighbours
    with jax.enable_x64(dtype == np.float64):  # JAX computes an f64 volume in f64 only with x64 on
        want, want_2d = jax_lbp_histogram(vol), jax_lbp_histogram(vol[0])
    got = lbp_histogram(vol)
    assert got.shape == (256,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lbp_histogram(vol[0]), want_2d)


def test_cli_flags_reach_the_run(brats_dir, tmp_path, capsys):
    """`--device-data` (which implies `--device-augment`) and
    `--perceptual-weight` reach `pretrain_kfold`: the resident line, and a
    positive perceptual term in every log row."""
    from vit_ae_plus_plus_torch import cli

    work = tmp_path / "run"
    argv = ["pretrain-kfold", "--device", "cpu", "--data-path", brats_dir, "--work-dir", str(work),
            "--model", "contr_mae_vit_tiny_patch4", "--volume-size", "16", "--patch-size", "4",
            "--batch-size", "4", "--epochs", "1", "--n-splits", "2", "--compute-dtype", "float32",
            "--device-data", "--perceptual-weight", "0.1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("dataset resident on the card (0.00 GB)") == FOLDS
    rows = _log(str(work))
    assert len(rows) == FOLDS and all(r["train_perceptual_loss"] > 0 for r in rows)
