"""The port's host data path against the JAX package's: NIfTI I/O, the scipy
transforms, the native augmenter and the datasets.

The same seeded numpy inputs go through both packages. The port's modules
are copies under the same generators, so their outputs must be bitwise
equal (`assert_array_equal`), except where the native augmenter stands in
for scipy: `NativeRandomAffine3D` against scipy's `RandomAffine3D` at
rtol = atol = 1e-5 and `NativeRandomGamma` against `RandomGamma` at
2e-5 (the tolerances of tests/test_native_augment.py: trilinear sums and
`pow` in f32 in another order than scipy's and numpy's), and `znorm` /
`minmax` against `normalize_volume` at 1e-5 (the C++ takes the moments in
f64 as E[x^2] - mean^2, numpy in f32 around the mean).

The JAX side builds its transforms from its scipy classes. It never calls
its own `default_ssl_transforms()` or `native_augment`: those build the JAX
package's library in place, which tests/test_native_augment.py builds too,
in another worker.
"""

import gzip
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vit_ae_plus_plus_torch.data import brats as tb
from vit_ae_plus_plus_torch.data import egd as te
from vit_ae_plus_plus_torch.data import native_augment as na
from vit_ae_plus_plus_torch.data import transforms as tt
from vit_ae_plus_plus_torch.data.factory import get_dataset as t_get_dataset
from vit_ae_plus_plus_torch.configs import DataConfig as TDataConfig
from vit_ae_plus_plus_torch.utils import nifti as tn
from vit_ae_plus_plus_tpu.configs import DataConfig as JDataConfig
from vit_ae_plus_plus_tpu.data import brats as jb
from vit_ae_plus_plus_tpu.data import egd as je
from vit_ae_plus_plus_tpu.data import transforms as jt
from vit_ae_plus_plus_tpu.data.factory import get_dataset as j_get_dataset
from vit_ae_plus_plus_tpu.utils import nifti as jn

REPO = Path(__file__).resolve().parents[1]
S = 16  # volume edge: every volume here is at most 16^3


def _vol(seed, shape=(1, S, S, S), scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + shift).astype(np.float32)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native augmenter is compiled on first use)")
    assert na.available(), "g++ is present but the native augmenter did not build"


# ---------------------------------------------------------------- NIfTI


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 3, 2, 2)])
def test_nifti_round_trip_and_read_match(tmp_path, suffix, shape):
    arr = _vol(1, shape, scale=3.0)
    t_path, j_path = tmp_path / f"t{suffix}", tmp_path / f"j{suffix}"
    tn.write_nifti(str(t_path), arr)
    jn.write_nifti(str(j_path), arr)
    t_bytes, j_bytes = t_path.read_bytes(), j_path.read_bytes()
    if suffix == ".nii.gz":  # gzip stamps the file name and time: compare the payload
        t_bytes, j_bytes = gzip.decompress(t_bytes), gzip.decompress(j_bytes)
    assert t_bytes == j_bytes
    np.testing.assert_array_equal(tn.read_nifti(str(t_path)), arr)
    data = j_path.read_bytes()
    np.testing.assert_array_equal(tn.read_nifti(data), jn.read_nifti(data))
    np.testing.assert_array_equal(tn.read_nifti(str(j_path)), jn.read_nifti(str(j_path)))
    assert tn.is_nifti(data) and jn.is_nifti(data)
    assert not tn.is_nifti(b"\x1f\x8b" + b"\x00" * 400) and not tn.is_nifti(b"abc")


@pytest.mark.parametrize("code,dtype", [(4, np.int16), (512, np.uint16), (64, np.float64)])
@pytest.mark.parametrize("byteorder", ["<", ">"])
def test_nifti_read_scaled_and_foreign_order_matches(code, dtype, byteorder):
    """Another datatype, byte order and scl_slope/scl_inter than the writer
    emits: a header patched by hand, read by both packages."""
    import struct

    arr = (np.random.default_rng(2).random((3, 4, 5)) * 100).astype(dtype)
    hdr = bytearray(348)
    struct.pack_into(byteorder + "i", hdr, 0, 348)
    struct.pack_into(byteorder + "8h", hdr, 40, 3, 3, 4, 5, 1, 1, 1, 1)
    struct.pack_into(byteorder + "h", hdr, 70, code)
    struct.pack_into(byteorder + "f", hdr, 108, 352.0)
    struct.pack_into(byteorder + "2f", hdr, 112, 0.5, -3.0)
    hdr[344:348] = b"n+1\x00"
    data = bytes(hdr) + b"\x00" * 4 + arr.astype(np.dtype(dtype).newbyteorder(byteorder)).tobytes(order="F")
    got = tn.read_nifti(data)
    np.testing.assert_array_equal(got, jn.read_nifti(data))
    np.testing.assert_allclose(got, arr.astype(np.float32) * 0.5 - 3.0, rtol=1e-6)
    with pytest.raises(ValueError):
        tn.read_nifti(bytes(hdr[:344]) + b"n+2\x00" + data[348:])


# ---------------------------------------------------------------- scipy transforms


TRANSFORMS = {
    "affine": (lambda m: m.RandomAffine3D(), 1.0),
    "affine_wide": (lambda m: m.RandomAffine3D(scales=0.3, degrees=30.0), 1.0),
    "noise": (lambda m: m.RandomNoise(std=0.1), 1.0),
    "gamma": (lambda m: m.RandomGamma((-0.3, 0.3)), 3.0),
    "blur": (lambda m: m.RandomBlur(std=2.0), 1.0),
    "compose": (lambda m: m.Compose([m.RandomAffine3D(), m.RandomNoise(0.1), m.RandomGamma((-0.3, 0.3))]), 1.0),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("k", [0, 7])
def test_scipy_transforms_are_bitwise_equal(name, k):
    make, scale = TRANSFORMS[name]
    shape = (2, 12, 10, S) if name != "compose" else (1, S, S, S)
    vol = _vol(10 + k, shape, scale=scale, shift=2.0 if name == "gamma" else 0.0)
    got = make(tt)(vol, np.random.default_rng(k))
    want = make(jt)(vol, np.random.default_rng(k))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_gamma_leaves_a_constant_volume_unchanged():
    vol = np.full((1, 4, 4, 4), 2.5, np.float32)
    got = tt.RandomGamma()(vol, np.random.default_rng(0))
    np.testing.assert_array_equal(got, jt.RandomGamma()(vol, np.random.default_rng(0)))
    np.testing.assert_array_equal(got, vol)


def test_default_policy_modes():
    """'never' is the scipy Compose (bitwise the JAX one); 'require' the
    native classes of the port; anything but 'never' prefers native."""
    never = tt.default_ssl_transforms(native="never")
    assert [type(t) for t in never.transforms] == [tt.RandomAffine3D, tt.RandomNoise, tt.RandomGamma]
    vol = _vol(3)
    want = jt.Compose([jt.RandomAffine3D(), jt.RandomNoise(std=0.1), jt.RandomGamma((-0.3, 0.3))])
    np.testing.assert_array_equal(never(vol, np.random.default_rng(4)), want(vol, np.random.default_rng(4)))


def test_default_policy_require_and_auto_are_native(gxx):
    for mode in ("require", "auto"):
        policy = tt.default_ssl_transforms(native=mode)
        assert [type(t) for t in policy.transforms] == [
            na.NativeRandomAffine3D, na.NativeRandomNoise, na.NativeRandomGamma]


def test_default_policy_require_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(na, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native augmentation library unavailable"):
        tt.default_ssl_transforms(native="require")
    assert isinstance(tt.default_ssl_transforms(native="auto").transforms[0], tt.RandomAffine3D)


# ---------------------------------------------------------------- native augmenter


def test_native_source_is_the_jax_packages_byte_for_byte():
    port = REPO / "vit_ae_plus_plus_torch" / "native" / "augment3d.cpp"
    assert na.SRC == port.resolve()
    assert port.read_bytes() == (REPO / "vit_ae_plus_plus_tpu" / "native" / "augment3d.cpp").read_bytes()


@pytest.mark.parametrize("k", [0, 1, 2])
def test_native_affine_matches_scipy_affine(gxx, k):
    vol = _vol(20 + k, (2, S, 14, 12))
    got = na.NativeRandomAffine3D()(vol, np.random.default_rng(k))
    want = jt.RandomAffine3D()(vol, np.random.default_rng(k))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_native_affine_identity_is_exact(gxx):
    vol = _vol(5, (8, 9, 10))
    np.testing.assert_array_equal(na.affine3d(vol, np.eye(3), np.zeros(3)), vol)


@pytest.mark.parametrize("k", [0, 9])
def test_native_gamma_matches_numpy_gamma(gxx, k):
    vol = np.random.default_rng(30 + k).random((1, 12, 12, 12)).astype(np.float32) * 3.0 - 0.5
    got = na.NativeRandomGamma()(vol, np.random.default_rng(k))
    want = jt.RandomGamma()(vol, np.random.default_rng(k))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_native_noise_distribution_and_determinism(gxx):
    """The distribution check of tests/test_native_augment.py, and the same
    generator state gives the same field bitwise, without touching the
    input."""
    vol = np.zeros((1, S, S, S), np.float32)
    rng = np.random.default_rng(3)
    outs = [na.NativeRandomNoise(std=0.1)(vol, rng) for _ in range(50)]
    stds = np.asarray([o.std() for o in outs])
    assert 0.0 <= stds.min() < 0.035
    assert stds.max() > 0.065
    assert abs(stds.mean() - 0.05) < 0.015
    assert np.all(np.abs([o.mean() for o in outs]) < 0.01)
    assert not vol.any()
    a = na.NativeRandomNoise(std=0.1)(_vol(6), np.random.default_rng(11))
    b = na.NativeRandomNoise(std=0.1)(_vol(6), np.random.default_rng(11))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _vol(6))


@pytest.mark.parametrize("use_z_score", [True, False])
def test_native_normalisations_match_normalize_volume(gxx, use_z_score):
    vol = _vol(7, scale=3.0, shift=1.0)
    got = na.znorm(vol) if use_z_score else na.minmax(vol)
    np.testing.assert_allclose(got, jb.normalize_volume(vol, use_z_score), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tb.normalize_volume(vol, use_z_score), jb.normalize_volume(vol, use_z_score))


BUILD_CHILD = """
import sys
from pathlib import Path
import numpy as np
from vit_ae_plus_plus_torch.data import native_augment as na
na.BUILD_DIR = Path(sys.argv[1])
assert na.available(), "no library"
vol = np.random.default_rng(0).standard_normal((1, 16, 16, 16)).astype(np.float32)
rng = np.random.default_rng(1)
out = na.NativeRandomNoise(0.1)(na.NativeRandomAffine3D()(vol, rng), rng)
np.save(sys.argv[2], na.NativeRandomGamma()(out, rng))
"""


def test_four_processes_build_into_one_empty_directory(gxx, tmp_path):
    """Four processes that find no library build it at once into one
    directory: each builds into a temporary file and moves it into place,
    so all four load a whole library and agree bitwise."""
    build = tmp_path / "build"
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CHILD, str(build), str(tmp_path / f"{i}.npy")],
                              cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for i in range(4)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    outs = [np.load(tmp_path / f"{i}.npy") for i in range(4)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert np.isfinite(outs[0]).all()
    assert [p.name for p in build.iterdir()] == [na.library_path().name]


# ---------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def brats_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("brats")
    rng = np.random.default_rng(0)
    for mode, n in (("whole", 6), ("train", 4)):
        np.save(root / f"x_{mode}_ssl.npy", (rng.standard_normal((n, S, S, S, 1)) * 2 + 3).astype(np.float32))
        np.save(root / f"y_{mode}_ssl.npy", np.arange(n) % 2)
    np.save(root / "x_test_ssl.npy", rng.standard_normal((2, S, S, S, 1)).astype(np.float32))  # no labels
    return str(root)


def _policy(module):
    return module.Compose([module.RandomAffine3D(), module.RandomNoise(0.1), module.RandomGamma((-0.3, 0.3))])


def _assert_items_equal(t_ds, j_ds, items, accesses=2):
    assert len(t_ds) == len(j_ds)
    for _ in range(accesses):
        for i in items:
            got, want = t_ds[i], j_ds[i]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2] == want[2] and type(got[2]) is type(want[2])


@pytest.mark.parametrize("transform", [None, "scipy"])
@pytest.mark.parametrize("use_z_score", [True, False])
@pytest.mark.parametrize("mode", ["whole", "test"])
def test_brats_items_equal(brats_dir, transform, use_z_score, mode):
    kw = dict(mode=mode, use_z_score=use_z_score, seed=3)
    t_ds = tb.BraTSDataset(brats_dir, transform=_policy(tt) if transform else None, **kw)
    j_ds = jb.BraTSDataset(brats_dir, transform=_policy(jt) if transform else None, **kw)
    _assert_items_equal(t_ds, j_ds, [0, 1, len(t_ds) - 1])
    if transform:  # the second access of an item draws fresh numbers
        first, second = t_ds[0][0], t_ds[0][0]
        assert not np.array_equal(first, second)


def test_brats_raw_items_equal(brats_dir):
    t_ds = tb.BraTSDataset(brats_dir, mode="train", raw=True, transform=_policy(tt))
    j_ds = jb.BraTSDataset(brats_dir, mode="train", raw=True, transform=_policy(jt))
    _assert_items_equal(t_ds, j_ds, range(4))
    aug, orig, _ = t_ds[2]
    assert aug is orig and aug.shape == (1, S, S, S)
    with pytest.raises(ValueError, match="invalid mode"):
        tb.BraTSDataset(brats_dir, mode="nope")


@pytest.fixture(scope="module")
def egd_dir(tmp_path_factory):
    """Per-scan directories of four modalities, and split lists: pickles for
    the idh split (the reference's own bootstrap), JSON for 1p19q."""
    import json
    import pickle

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
    with open(split_dir / "correct_who_1p19q_codeletion_annotated_mit_labels.json", "w") as f:
        json.dump([["MR_001", 1], ["MR_003", 0]], f)
    return str(root)


@pytest.mark.parametrize("mode,split", [("whole", "idh"), ("test", "idh"), ("ssl", "idh"), ("test", "1p19q")])
@pytest.mark.parametrize("transform", [None, "scipy"])
@pytest.mark.parametrize("use_z_score", [True, False])
def test_egd_items_equal(egd_dir, mode, split, transform, use_z_score):
    kw = dict(mode=mode, split=split, use_z_score=use_z_score, seed=5)
    split_dir = os.path.join(egd_dir, "splits")
    t_ds = te.EGDDataset(egd_dir, split_dir, transform=_policy(tt) if transform else None, **kw)
    j_ds = je.EGDDataset(egd_dir, split_dir, transform=_policy(jt) if transform else None, **kw)
    _assert_items_equal(t_ds, j_ds, range(len(t_ds)))
    assert t_ds[0][0].shape == (4, 12, 12, 12)


def test_egd_raw_items_and_split_names_equal(egd_dir):
    split_dir = os.path.join(egd_dir, "splits")
    t_ds = te.EGDDataset(egd_dir, split_dir, mode="test", raw=True, transform=_policy(tt))
    j_ds = je.EGDDataset(egd_dir, split_dir, mode="test", raw=True, transform=_policy(jt))
    _assert_items_equal(t_ds, j_ds, range(len(t_ds)))
    for mode in ("ssl", "test", "whole", "whole_train"):
        for split in ("idh", "1p19q"):
            assert te.split_filename(mode, split) == je.split_filename(mode, split)
    with pytest.raises(ValueError, match="invalid split"):
        te.split_filename("ssl", "nope")
    vol = _vol(8, (4, 6, 6, 6), scale=2.0, shift=1.0)
    for z in (True, False):
        np.testing.assert_array_equal(te.normalize_per_channel(vol, z), je.normalize_per_channel(vol, z))


@pytest.mark.parametrize("name", ["brats", "egd"])
def test_get_dataset_matches(brats_dir, egd_dir, name):
    base = brats_dir if name == "brats" else egd_dir
    t_ds = t_get_dataset(name, "whole", TDataConfig(base_path=base), transforms=_policy(tt), use_z_score=True)
    j_ds = j_get_dataset(name, "whole", JDataConfig(base_path=base), transforms=_policy(jt), use_z_score=True)
    assert type(t_ds).__name__ == type(j_ds).__name__
    _assert_items_equal(t_ds, j_ds, [0, len(t_ds) - 1])
    with pytest.raises(ValueError, match="unknown dataset"):
        t_get_dataset("nope", "whole", TDataConfig())


def test_data_config_fields_and_defaults_match():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(TDataConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JDataConfig)]
