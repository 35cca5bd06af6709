"""The port's split bootstrap (data/splits.py) and its `prepare-data`
command against the JAX package's.

Every file either side writes is compared byte for byte, output tree
against output tree, and the returned indices bitwise: the port is a copy
that writes the same files. The JAX package draws its splits with
scikit-learn; the port's numpy copies of the two algorithms are also held
to scikit-learn directly, over label sets of several sizes, class counts
and balances.
"""

import json
import pickle
import warnings
from pathlib import Path

import numpy as np
import pytest
from sklearn.model_selection import StratifiedKFold, train_test_split

from vit_ae_plus_plus_torch import cli as t_cli
from vit_ae_plus_plus_torch.data import splits as ts
from vit_ae_plus_plus_torch.utils.nifti import write_nifti
from vit_ae_plus_plus_tpu import cli as j_cli
from vit_ae_plus_plus_tpu.data import splits as js


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_trees_equal(a: Path, b: Path) -> dict:
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for name in ta:
        assert ta[name] == tb[name], name
    return ta


def _labels(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(12, 90))
    k = int(rng.integers(2, 5))
    p = rng.dirichlet(np.ones(k) * 2)
    y = rng.choice(k, size=n, p=p)
    while np.bincount(y, minlength=k).min() < 6:  # every class splits 90/10 twice
        y = np.concatenate([y, np.arange(k)])
    return y


@pytest.mark.parametrize("seed", range(8))
def test_stratified_split_is_sklearns(seed):
    y = _labels(seed)
    idx = np.arange(100, 100 + len(y))
    for random_state in (0, 42):
        got = ts.stratified_train_test_split(idx, y, 0.9, random_state)
        want = train_test_split(idx, train_size=0.9, stratify=y, random_state=random_state)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_stratified_kfold_is_sklearns(seed, n_splits):
    y = _labels(seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        want = list(StratifiedKFold(n_splits=n_splits, shuffle=False).split(np.zeros(len(y)), y))
        got = ts.stratified_kfold(y, n_splits)
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_split_helpers_refuse_what_sklearn_refuses():
    with pytest.raises(ValueError, match="only 1 member"):
        ts.stratified_train_test_split(np.arange(12), np.array([0] * 11 + [1]), 0.9, 42)
    with pytest.raises(ValueError, match="greater than the number of members"):
        ts.stratified_kfold(np.array([0, 0, 1, 1]), 3)
    with pytest.raises(ValueError, match="number of samples"):
        ts.stratified_kfold(np.array([0, 1]), 3)


@pytest.mark.parametrize("n_splits", [2, 3])
def test_kfold_indices_files_and_legacy_pickles(tmp_path, n_splits):
    labels = np.array([0, 1, 1] * 5)
    t_dir, j_dir = tmp_path / "t", tmp_path / "j"
    got = ts.kfold_indices(labels, n_splits, str(t_dir))
    want = js.kfold_indices(labels, n_splits, str(j_dir))
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert len(_assert_trees_equal(t_dir, j_dir)) == 2 * n_splits
    for (a, b), (c, d) in zip(ts.kfold_indices(labels, n_splits, str(t_dir)), got):  # read back
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for (a, b), (c, d) in zip(ts.kfold_indices(labels, n_splits), got):  # nothing persisted
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)

    legacy = tmp_path / "legacy"
    legacy.mkdir()
    for fold in range(n_splits):
        for name, ids in (("train", np.array([5, 6, 7]) + fold), ("test", np.array([1, 2]))):
            with open(legacy / f"{name}_{fold}", "wb") as f:
                pickle.dump(ids, f)
    for (a, b), (c, d) in zip(ts.kfold_indices(labels, n_splits, str(legacy)),
                              js.kfold_indices(labels, n_splits, str(legacy))):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert not list(legacy.glob("*.npy"))


@pytest.fixture
def brats_npy(tmp_path):
    rng = np.random.default_rng(0)
    vols = rng.standard_normal((30, 8, 8, 8, 1)).astype(np.float32)
    labels = np.array([0, 1] * 15)
    np.save(tmp_path / "flair_all.npy", vols)
    np.save(tmp_path / "label_all.npy", labels)
    return tmp_path / "flair_all.npy", tmp_path / "label_all.npy"


def test_split_brats_data_writes_the_same_files(tmp_path, brats_npy):
    vols, labels = map(str, brats_npy)
    got = ts.split_brats_data(vols, labels, str(tmp_path / "t"))
    want = js.split_brats_data(vols, labels, str(tmp_path / "j"))
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    tree = _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    assert len(tree) == 11  # 3 index files, x and y for 4 modes
    with pytest.raises(FileExistsError):
        ts.split_brats_data(vols, labels, str(tmp_path / "t"))
    ts.split_brats_data(vols, labels, str(tmp_path / "t"), overwrite=True)
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")


def _nifti_scans(root: Path, n: int = 12, s: int = 8):
    root.mkdir()
    rng = np.random.default_rng(1)
    rows = ["name,label"]
    for i in range(n):
        write_nifti(str(root / f"scan_{i:02d}{'.nii.gz' if i % 3 else '.nii'}"),
                    rng.standard_normal((s, s, s)).astype(np.float32) * 100)
        rows.append(f"scan_{i:02d},{float(i % 2) if i % 4 else i % 2}")
    (root.parent / "labels.csv").write_text("\n".join(rows) + "\n")
    return root, root.parent / "labels.csv"


def test_ingest_nifti_volumes_writes_the_same_files(tmp_path, capsys):
    scans, csv = _nifti_scans(tmp_path / "scans")
    got = ts.ingest_nifti_volumes(str(scans), str(csv), str(tmp_path / "t"))
    want = js.ingest_nifti_volumes(str(scans), str(csv), str(tmp_path / "j"))
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace(str(tmp_path / "t"), "") == out[1].replace(str(tmp_path / "j"), "")
    with pytest.raises(FileExistsError):
        ts.ingest_nifti_volumes(str(scans), str(csv), str(tmp_path / "t"))
    (tmp_path / "bad.csv").write_text("name,label\nscan_00,x\n")
    for mod in (ts, js):
        with pytest.raises(ValueError, match="not numeric"):
            mod.ingest_nifti_volumes(str(scans), str(tmp_path / "bad.csv"), str(tmp_path / "e"))


def _egd_tree(tmp_path: Path, nifti: bool = False):
    """Per-scan modality files (npy, or NIfTI with one scan missing a
    modality) and a radiologist csv with SSL (-1) and labelled rows."""
    rng = np.random.default_rng(3)
    root = tmp_path / ("nifti" if nifti else "scans")
    for i in range(7):
        d = root / f"MR_{i:03d}"
        d.mkdir(parents=True)
        for m in ("flair", "t1ce", "t1", "t2"):
            vol = rng.standard_normal((6, 6, 6)).astype(np.float32)
            if nifti and not (i == 5 and m == "t2"):
                write_nifti(str(d / f"{m}.nii.gz"), vol)
            elif not nifti and not (i == 6 and m == "t1"):
                np.save(d / f"{m}.npy", vol)
    with open(tmp_path / "rad.csv", "w") as f:
        f.write("idx,Subject,who_idh_mutation_status,who_1p19q_codeletion\n")
        for i in range(7):
            f.write(f"{i},{i:03d},{i % 2 if i < 4 else -1},{(i + 1) % 2 if i % 3 else -1}\n")
    return root, tmp_path / "rad.csv"


def test_egd_split_functions_write_the_same_files(tmp_path, capsys):
    scans, csv = _egd_tree(tmp_path)
    for side, mod in (("t", ts), ("j", js)):
        out = tmp_path / side
        for col in ("who_idh_mutation_status", "who_1p19q_codeletion"):
            ssl, labelled = mod.prepare_egd_splits(str(csv), str(scans), str(out), col)
            assert ssl and labelled
        mod.refine_1p19q_scans(str(out))
    tree = _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    assert len(tree) == 7
    refined = json.loads(tree["correct_who_1p19q_codeletion_annotated_mit_labels.json"])
    assert refined and all(item[0] != "MR_006" for item in refined)
    printed = capsys.readouterr().out.splitlines()
    assert printed[: len(printed) // 2] == printed[len(printed) // 2:]


def test_convert_egd_nifti_scans_writes_the_same_files(tmp_path, capsys):
    nifti, _ = _egd_tree(tmp_path, nifti=True)
    assert ts.convert_egd_nifti_scans(str(nifti), str(tmp_path / "t")) == 6
    assert js.convert_egd_nifti_scans(str(nifti), str(tmp_path / "j")) == 6
    _assert_trees_equal(tmp_path / "t", tmp_path / "j")
    assert "skipping MR_005: missing modalities ['t2']" in capsys.readouterr().out
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ts.convert_egd_nifti_scans(str(tmp_path / "empty"), str(tmp_path / "e"))


def _both_clis(tmp_path: Path, *args: str) -> dict:
    """Run `prepare-data` through each package's `main` into its own out
    dir; -> the port's output tree, after holding it to the JAX one."""
    for side, cli in (("t", t_cli), ("j", j_cli)):
        assert cli.main(["prepare-data", *args, "--out-dir", str(tmp_path / side)]) == 0
    return _assert_trees_equal(tmp_path / "t", tmp_path / "j")


def test_cli_prepare_data_brats_npy(tmp_path, brats_npy):
    vols, labels = brats_npy
    tree = _both_clis(tmp_path, "brats", "--volumes", str(vols), "--labels", str(labels))
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "x_whole_ssl.npy"), np.load(vols))
    assert len(tree) == 11
    with pytest.raises(FileExistsError):
        t_cli.main(["prepare-data", "brats", "--volumes", str(vols), "--labels", str(labels),
                    "--out-dir", str(tmp_path / "t")])
    assert t_cli.main(["prepare-data", "brats", "--volumes", str(vols), "--labels", str(labels),
                       "--out-dir", str(tmp_path / "t"), "--overwrite"]) == 0


def test_cli_prepare_data_brats_nifti(tmp_path):
    scans, csv = _nifti_scans(tmp_path / "scans", n=20)
    tree = _both_clis(tmp_path, "brats", "--nifti-dir", str(scans), "--labels-csv", str(csv))
    assert "volumes_all.npy" in tree and "x_train_ssl.npy" in tree
    with pytest.raises(SystemExit, match="--labels-csv"):
        t_cli.main(["prepare-data", "brats", "--nifti-dir", str(scans), "--out-dir", str(tmp_path / "e")])


def test_cli_prepare_data_egd(tmp_path):
    root, csv = _egd_tree(tmp_path)
    tree = _both_clis(tmp_path, "egd", "--csv", str(csv), "--scans-root", str(root))
    assert "correct_who_1p19q_codeletion_annotated_mit_labels.json" in tree
    with pytest.raises(SystemExit, match="--csv"):
        t_cli.main(["prepare-data", "egd", "--scans-root", str(root), "--out-dir", str(tmp_path / "e")])


def test_cli_prepare_data_egd_nifti(tmp_path):
    """`prepare-data egd --nifti-dir`: the port's command against the steps
    of the JAX command's body (vit_ae_plus_plus_tpu/cli.py:485-495), called
    one by one: that command itself stops at its `os.path.join` (:489),
    since a later `import os` inside its `main` (:438) makes `os` a local
    name there."""
    root, csv = _egd_tree(tmp_path, nifti=True)
    assert t_cli.main(["prepare-data", "egd", "--csv", str(csv), "--nifti-dir", str(root),
                       "--out-dir", str(tmp_path / "t")]) == 0
    out = tmp_path / "j"
    js.convert_egd_nifti_scans(str(root), str(out / "scans"))
    for col in ("who_idh_mutation_status", "who_1p19q_codeletion"):
        js.prepare_egd_splits(str(csv), str(out / "scans"), str(out), col)
    js.refine_1p19q_scans(str(out))
    tree = _assert_trees_equal(tmp_path / "t", out)
    assert sum(name.startswith("scans/") for name in tree) == 6 * 4
