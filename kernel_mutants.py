#!/usr/bin/env python3
"""Mutation check of the attention kernel's tolerances, on one NVIDIA GPU.

    python3 kernel_mutants.py

Run from the root of a checkout. For each mutant below it copies the port
(`vit_ae_plus_plus_torch/`, `chip_smoke.py`, the CUDA kernel tests) into
`vit_ae_plus_plus_torch/build/mutants/<name>/`, breaks
`kernels/csrc/flash_fwd.cu` there on purpose, builds every copy at once, and
runs two checks against each broken kernel:

- `tests/test_torch_port_kernels_cuda.py`, the kernel against its plain
  version at small ragged shapes;
- `chip_smoke.kernel_case` at the serving shape (packed, B=8, N=1729,
  C=768, d=64, bf16).

Each check must fail: a tolerance loose enough to pass a broken kernel shows
here. Prints one line per mutant and exits 0 only when every mutant is
caught by both checks.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
KERNEL = Path("vit_ae_plus_plus_torch/kernels/csrc/flash_fwd.cu")
KERNEL_TESTS = Path("tests/test_torch_port_kernels_cuda.py")
# name -> (text in the kernel source, its broken replacement at every occurrence)
MUTANTS = {
    "drop_last_key_tile": (
        "for (int k0 = 0; k0 < n; k0 += kBlockK)",
        "for (int k0 = 0; k0 + kBlockK < n; k0 += kBlockK)",
    ),
    "unmasked_key_tail": (
        "const float x = key < n ? s[j][e] * scale2 : -INFINITY;",
        "const float x = key <= n ? s[j][e] * scale2 : -INFINITY;",
    ),
    "scale_off_1pct": (
        "const float scale2 = p.scale * kLog2e;",
        "const float scale2 = p.scale * kLog2e * 1.01f;",
    ),
}
SERVING_CASE = "chip_smoke.kernel_case('packed bf16 N1729 d64', 'packed', 8, 12, 1729, 64, 'bfloat16', seed=0)"


def make_copy(name: str, old: str, new: str) -> Path:
    root = REPO / "vit_ae_plus_plus_torch" / "build" / "mutants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(
        REPO / "vit_ae_plus_plus_torch", root / "vit_ae_plus_plus_torch",
        ignore=shutil.ignore_patterns("build", "__pycache__"),
    )
    for f in ("chip_smoke.py", "pyproject.toml", KERNEL_TESTS):
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / f, root / f)
    src = (root / KERNEL).read_text()
    if old not in src:
        raise SystemExit(f"kernel_mutants: {name}: {old!r} is not in {KERNEL}")
    (root / KERNEL).write_text(src.replace(old, new))
    return root


def run(cmd, cwd: Path, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device", file=sys.stderr)
        return 1
    roots = {name: make_copy(name, *edit) for name, edit in MUTANTS.items()}
    builds = {
        name: subprocess.Popen(
            [sys.executable, "-c", "from vit_ae_plus_plus_torch.kernels import _build; _build.build()"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name, root in roots.items()
    }
    for name, proc in builds.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_mutants: {name} did not build:\n{log}")

    missed = []
    for name, root in roots.items():
        tests = run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                     "-p", "no:cacheprovider", str(KERNEL_TESTS)], root, timeout=600)
        tally = re.findall(r"(\d+) (failed|passed)", tests.stdout)
        serving = run([sys.executable, "-c", f"import chip_smoke; {SERVING_CASE}"], root, timeout=600)
        reason = (serving.stderr.strip().splitlines() or ["(no message)"])[-1]
        caught_tests = tests.returncode == 1 and any(kind == "failed" for _, kind in tally)
        caught_serving = serving.returncode != 0 and "chip_smoke FAILED" in serving.stderr
        print(f"mutant {name}: kernel tests {'caught' if caught_tests else 'MISSED'} "
              f"({', '.join(f'{n} {k}' for n, k in tally) or tests.stdout[-300:]}); "
              f"serving shape {'caught' if caught_serving else 'MISSED'} ({reason})", flush=True)
        if not (caught_tests and caught_serving):
            missed.append(name)
    shutil.rmtree(REPO / "vit_ae_plus_plus_torch" / "build" / "mutants", ignore_errors=True)
    if missed:
        print(f"kernel_mutants: not caught: {missed}", file=sys.stderr)
        return 1
    print(f"kernel_mutants: all {len(MUTANTS)} mutants caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
