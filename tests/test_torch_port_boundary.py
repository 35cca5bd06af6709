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
    return files + [REPO / "chip_smoke.py", REPO / "kernel_mutants.py"]


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


def test_importing_serving_and_cli_loads_no_jax():
    code = (
        "import sys, vit_ae_plus_plus_torch.serving, vit_ae_plus_plus_torch.cli\n"
        "import vit_ae_plus_plus_torch.parallel, vit_ae_plus_plus_torch.kernels.ring_flash\n"
        "import vit_ae_plus_plus_torch.pipelines.pretrain_kfold\n"
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


def test_native_augmenter_builds_from_the_ports_source_into_its_build_dir():
    from vit_ae_plus_plus_torch.data import native_augment as na
    from vit_ae_plus_plus_torch.kernels import _build

    pkg = (REPO / "vit_ae_plus_plus_torch").resolve()
    assert na.SRC.resolve().is_relative_to(pkg) and na.SRC.is_file()
    assert na.BUILD_DIR.resolve() == _build.BUILD_DIR.resolve() == pkg / "build"
    assert na.library_path().parent == na.BUILD_DIR
    assert "vit_ae_plus_plus_torch/build/" in (REPO / ".gitignore").read_text().split()
