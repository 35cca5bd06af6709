"""The port's boundary: it imports no JAX and nothing of the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex", "vit_ae_plus_plus_tpu")


def _port_sources():
    pkg = REPO / "vit_ae_plus_plus_torch"
    # build/ holds the kernels' build output (gitignored), not sources
    files = sorted(f for f in pkg.rglob("*.py") if f.relative_to(pkg).parts[0] != "build")
    return files + [REPO / "chip_smoke.py", REPO / "kernel_mutants.py", REPO / "moco_step_conditioning.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = {
        f"{f.relative_to(REPO)}: {root}"
        for f in files for root in _imported_roots(f) if root in FORBIDDEN
    }
    assert not bad, sorted(bad)


def test_port_sources_import_no_sklearn():
    """The GPU machine has no scikit-learn: the port carries its own copies
    of what the classical evaluation runs, and imports none of it, not even
    where it is installed."""
    bad = {f"{f.relative_to(REPO)}: {root}" for f in _port_sources() for root in _imported_roots(f)
           if root == "sklearn"}
    assert not bad, sorted(bad)
    code = ("import sys, vit_ae_plus_plus_torch.cli, vit_ae_plus_plus_torch.pipelines.classical_models\n"
            "import vit_ae_plus_plus_torch.pipelines.eval_classical, vit_ae_plus_plus_torch.utils.linear_loss\n"
            "import vit_ae_plus_plus_torch.utils.liblinear, vit_ae_plus_plus_torch.utils.sag\n"
            "import vit_ae_plus_plus_torch.utils.tree, vit_ae_plus_plus_torch.pipelines.forest\n"
            "sys.exit(1 if [m for m in sys.modules if m.split('.')[0] == 'sklearn'] else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_serving_and_cli_loads_no_jax():
    code = (
        "import sys, vit_ae_plus_plus_torch.serving, vit_ae_plus_plus_torch.cli\n"
        "import vit_ae_plus_plus_torch.parallel, vit_ae_plus_plus_torch.kernels.ring_flash\n"
        "import vit_ae_plus_plus_torch.pipelines.pretrain_kfold\n"
        "import vit_ae_plus_plus_torch.pipelines.extract_features, vit_ae_plus_plus_torch.pipelines.finetune\n"
        "import vit_ae_plus_plus_torch.pipelines.probe_kfold, vit_ae_plus_plus_torch.utils.metrics\n"
        "import vit_ae_plus_plus_torch.pipelines.resnet_kfold, vit_ae_plus_plus_torch.pipelines.eval_classical\n"
        "import vit_ae_plus_plus_torch.models.resnet3d, vit_ae_plus_plus_torch.utils.libsvm\n"
        "import vit_ae_plus_plus_torch.models.moco, vit_ae_plus_plus_torch.pipelines.moco_kfold\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    from vit_ae_plus_plus_torch.device import resolve_device
    from vit_ae_plus_plus_torch.serving import FeatureEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureEngine(mae_params={}, model_name="contr_mae_vit_tiny_patch4", volume_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_pretrain_kfold_raises_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.pipelines.pretrain_kfold import pretrain_kfold

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data_cfg = DataConfig(base_path=str(tmp_path / "no_data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_kfold(data_cfg, TrainConfig(), str(tmp_path / "w"))
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on, to the data
        pretrain_kfold(data_cfg, TrainConfig(), str(tmp_path / "w"), device="cpu")


def test_downstream_pipelines_raise_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.pipelines.extract_features import extract_ssl_features
    from vit_ae_plus_plus_torch.pipelines.finetune import finetune_single
    from vit_ae_plus_plus_torch.pipelines.probe_kfold import probe_kfold

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data_cfg = DataConfig(base_path=str(tmp_path / "no_data"))
    ckpt = str(tmp_path / "none.pth")
    runs = (
        lambda **kw: extract_ssl_features(data_cfg, ckpt, str(tmp_path / "f"), **kw),
        lambda **kw: probe_kfold(data_cfg, TrainConfig(), str(tmp_path / "p"), str(tmp_path), **kw),
        lambda **kw: probe_kfold(data_cfg, TrainConfig(), str(tmp_path / "k"), str(tmp_path),
                                 fix_backbone=False, **kw),
        lambda **kw: finetune_single(data_cfg, TrainConfig(), str(tmp_path / "s"), ckpt, **kw),
    )
    for run in runs:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
        with pytest.raises(FileNotFoundError):  # on the CPU it goes on, to the files
            run(device="cpu")


def test_native_augmenter_builds_from_the_ports_source_into_its_build_dir():
    from vit_ae_plus_plus_torch.data import native_augment as na
    from vit_ae_plus_plus_torch.kernels import _build

    pkg = (REPO / "vit_ae_plus_plus_torch").resolve()
    assert na.SRC.resolve().is_relative_to(pkg) and na.SRC.is_file()
    assert na.BUILD_DIR.resolve() == _build.BUILD_DIR.resolve() == pkg / "build"
    assert na.library_path().parent == na.BUILD_DIR
    assert "vit_ae_plus_plus_torch/build/" in (REPO / ".gitignore").read_text().split()


def test_resnet_kfold_raises_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.pipelines.resnet_kfold import resnet_kfold

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data_cfg = DataConfig(base_path=str(tmp_path / "no_data"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet_kfold(data_cfg, TrainConfig(), str(tmp_path / "r"))
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on, to the data
        resnet_kfold(data_cfg, TrainConfig(), str(tmp_path / "r"), device="cpu")


def test_libsvm_builds_from_the_ports_sources_into_its_build_dir():
    """The copy of scikit-learn's libsvm is the port's own: every source in
    the package's native/libsvm/, every quoted include naming a file there
    (none outside it, none of scikit-learn's or the JAX package's), the
    library in the package's build/, built without fast-math or FMA
    contraction."""
    import re

    from vit_ae_plus_plus_torch.kernels import _build
    from vit_ae_plus_plus_torch.utils import libsvm

    pkg = (REPO / "vit_ae_plus_plus_torch").resolve()
    src = libsvm.SRC_DIR.resolve()
    assert src == pkg / "native" / "libsvm"
    names = set(libsvm.SOURCES)
    assert names == {p.name for p in src.iterdir() if p.suffix in (".c", ".cpp", ".h")}
    for name in names:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', (src / name).read_text(), flags=re.M):
            assert inc in names, f"{name} includes {inc}"
    assert "Copyright (c) 2000-2009 Chih-Chung Chang and Chih-Jen Lin" in (src / "svm.cpp").read_text()
    assert "BSD" in (src / "COPYING").read_text()
    assert libsvm.BUILD_DIR.resolve() == _build.BUILD_DIR.resolve() == pkg / "build"
    assert libsvm.library_path().parent == libsvm.BUILD_DIR
    assert "-ffp-contract=off" in libsvm.GXX_FLAGS
    assert not any(f.startswith(("-ffast-math", "-march", "-Ofast")) for f in libsvm.GXX_FLAGS)


@pytest.mark.parametrize("library", ["liblinear", "sag", "tree"])
def test_liblinear_and_sag_build_from_the_ports_sources_into_its_build_dir(library):
    """The copies of scikit-learn's liblinear, of its SAG solver and half
    binomial loss, and of its tree builder are the port's own: every source
    in the package's native/ (each listed source a file of the library's
    directory, every quoted include naming a file under native/, none of
    scikit-learn's or the JAX package's), the library in the package's
    build/, built without fast-math, FMA contraction or -march; liblinear's
    COPYRIGHT is kept."""
    import importlib
    import re

    from vit_ae_plus_plus_torch.kernels import _build

    module = importlib.import_module(f"vit_ae_plus_plus_torch.utils.{library}")
    pkg = (REPO / "vit_ae_plus_plus_torch").resolve()
    native = pkg / "native"
    src = module.SRC_DIR.resolve()
    assert src == native / library
    names = set(module.SOURCES)
    assert names == {p.name for p in src.iterdir() if p.suffix in (".c", ".cpp", ".h")}
    for name in names:
        for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', (src / name).read_text(), flags=re.M):
            target = (src / inc).resolve()
            assert target.is_relative_to(native) and target.is_file(), f"{name} includes {inc}"
            assert target.parent == src or target in [p.resolve() for p in getattr(module, "INCLUDED", ())], inc
    assert module.BUILD_DIR.resolve() == _build.BUILD_DIR.resolve() == pkg / "build"
    assert module.library_path().parent == module.BUILD_DIR
    assert "-ffp-contract=off" in module.GXX_FLAGS
    assert not any(f.startswith(("-ffast-math", "-march", "-Ofast")) for f in module.GXX_FLAGS)
    if library == "liblinear":
        assert "Copyright (c) 2007-2014 The LIBLINEAR Project." in (src / "COPYRIGHT").read_text()
        assert "BSD" in (src / "COPYING").read_text()
    else:
        assert "BSD" in (src / "COPYING").read_text()


def test_moco_refuses_before_any_file_is_read(monkeypatch, tmp_path):
    """`moco_kfold` refuses FSDP with `NotImplementedError`, more devices
    than the process's 'data' axis has (`n_devices`, a data mesh shape)
    with `ValueError`, and a default device without CUDA with
    `RuntimeError`, before it reads the (missing) data or writes the work
    dir; `moco_extract` refuses the missing card likewise."""
    from vit_ae_plus_plus_torch.configs import DataConfig, TrainConfig
    from vit_ae_plus_plus_torch.pipelines.moco_kfold import moco_extract, moco_kfold

    data_cfg = DataConfig(base_path=str(tmp_path / "no_data"))
    work = tmp_path / "w"
    refused = ((NotImplementedError, "ROADMAP Queue 1 item 6", {"fsdp": True}),
               (NotImplementedError, "ROADMAP Queue 1 item 6", {"train_cfg": TrainConfig(fsdp=True)}),
               (ValueError, "n_devices=2 trains on 2 ranks", {"n_devices": 2}),
               (ValueError, "n_devices=2 trains on 2 ranks", {"train_cfg": TrainConfig(mesh_shape=(2,))}))
    for error, match, kw in refused:
        train_cfg = kw.pop("train_cfg", TrainConfig())
        with pytest.raises(error, match=match):
            moco_kfold(data_cfg, train_cfg, str(work), device="cpu", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moco_kfold(data_cfg, TrainConfig(), str(work))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moco_extract(data_cfg, str(tmp_path / "none.pth"), str(work))
    assert {p.name for p in work.iterdir()} <= {".writer.lock"}  # nothing written but the lock
    with pytest.raises(FileNotFoundError):  # on the CPU it goes on, to the data
        moco_kfold(data_cfg, TrainConfig(), str(work), device="cpu")
