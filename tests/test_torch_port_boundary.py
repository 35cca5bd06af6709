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
