#!/usr/bin/env python3
"""Mutation check of the CUDA kernels' tolerances, on one NVIDIA GPU.

    python3 kernel_mutants.py

Run from the root of a checkout. For each mutant below it copies the port
(`vit_ae_plus_plus_torch/`, `chip_smoke.py`, the CUDA kernel tests) into
`vit_ae_plus_plus_torch/build/mutants/<name>/`, breaks one kernel source
under `kernels/csrc/` there on purpose, builds every copy at once, and runs
two checks against each broken kernel:

- `tests/test_torch_port_kernels_cuda.py`, the kernels against their plain
  versions at small ragged shapes;
- at a main-path shape: `chip_smoke.kernel_case` at the serving shape
  (packed, B=8, N=1729, C=768, d=64, bf16) for a forward mutant,
  `chip_smoke.bwd_case` at the decoder's training shape (packed, B=8,
  N=1729, C=512, d=32, bf16) for a backward mutant;
  `chip_smoke.ln_dense_cases` at the training encoder's qkv shape (R=6928,
  C=768, F=2304, bf16, forward and backward) for a LayerNorm+Dense or
  LayerNorm row-pass mutant.

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
CSRC = Path("vit_ae_plus_plus_torch/kernels/csrc")
KERNEL_TESTS = Path("tests/test_torch_port_kernels_cuda.py")
FWD_CASE = "chip_smoke.kernel_case('packed bf16 N1729 d64', 'packed', 8, 12, 1729, 64, 'bfloat16', seed=0)"
BWD_CASE = "chip_smoke.bwd_case('packed bwd bf16 N1729 d32', 'packed', 8, 16, 1729, 32, 'bfloat16', seed=13)"
LND_CASE = "chip_smoke.ln_dense_cases('ln_dense bf16 encoder qkv', 6928, 768, 2304, 'bfloat16', seed=40)"
# name -> (source, text in it, its broken replacement at every occurrence, main-path check)
MUTANTS = {
    "drop_last_key_tile": (
        "flash_fwd.cu",
        "for (int k0 = 0; k0 < n; k0 += kBlockK)",
        "for (int k0 = 0; k0 + kBlockK < n; k0 += kBlockK)",
        FWD_CASE,
    ),
    "unmasked_key_tail": (
        "flash_fwd.cu",
        "const float x = key < n ? s[j][e] * scale2 : -INFINITY;",
        "const float x = key <= n ? s[j][e] * scale2 : -INFINITY;",
        FWD_CASE,
    ),
    "scale_off_1pct": (
        "flash_fwd.cu",
        "const float scale2 = p.scale * kLog2e;",
        "const float scale2 = p.scale * kLog2e * 1.01f;",
        FWD_CASE,
    ),
    "bwd_drop_last_query_tile": (  # the dK/dV loop skips the ragged last query tile
        "flash_bwd.cu",
        "for (int q0 = 0; q0 < n; q0 += kBlock)",
        "for (int q0 = 0; q0 + kBlock < n; q0 += kBlock)",
        BWD_CASE,
    ),
    "bwd_no_delta": (  # dS = P * dP, delta = rowsum(dO * O) left out
        "flash_bwd.cu",
        "if (lane == 0) p.delta[r] = acc;",
        "if (lane == 0) p.delta[r] = 0.f;",
        BWD_CASE,
    ),
    "bwd_dk_unscaled": (  # dK = dS^T Q without the softmax scale
        "flash_bwd.cu",
        "pack_f32(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale)",
        "pack_f32(dk[j][2 * r], dk[j][2 * r + 1])",
        BWD_CASE,
    ),
    "lnd_bias_before_rounding": (  # y = bf16(acc + b): the bias added before acc is rounded
        "ln_dense.cu",
        "return __bfloat162float(__float2bfloat16(acc)) + bias;",
        "return acc + bias;",
        LND_CASE,
    ),
    "lnd_dln_drop_last_tile": (  # the dln product skips its last tile of F
        "ln_dense.cu",
        "for (int kt = 0; kt < ktiles; ++kt)",
        "for (int kt = 0; kt < ktiles - 1; ++kt)",
        LND_CASE,
    ),
    "ln_rows_no_mean_gxhat": (  # dx = rstd * (g - mean(g)): the mean(g * xhat) term left out
        "ln_rows.cuh",
        "g[j][e] - mg - xh[j][e] * mgx",
        "g[j][e] - mg",
        LND_CASE,
    ),
}


def make_copy(name: str, source: str, old: str, new: str) -> Path:
    root = REPO / "vit_ae_plus_plus_torch" / "build" / "mutants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(
        REPO / "vit_ae_plus_plus_torch", root / "vit_ae_plus_plus_torch",
        ignore=shutil.ignore_patterns("build", "__pycache__"),
    )
    for f in ("chip_smoke.py", "pyproject.toml", KERNEL_TESTS):
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / f, root / f)
    kernel = root / CSRC / source
    src = kernel.read_text()
    if old not in src:
        raise SystemExit(f"kernel_mutants: {name}: {old!r} is not in {CSRC / source}")
    kernel.write_text(src.replace(old, new))
    return root


def run(cmd, cwd: Path, timeout: float) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_mutants: no CUDA device", file=sys.stderr)
        return 1
    roots = {name: make_copy(name, *edit[:3]) for name, edit in MUTANTS.items()}
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
        case = MUTANTS[name][3]
        main_path = run([sys.executable, "-c", f"import chip_smoke; {case}"], root, timeout=600)
        reason = (main_path.stderr.strip().splitlines() or ["(no message)"])[-1]
        caught_tests = tests.returncode == 1 and any(kind == "failed" for _, kind in tally)
        caught_main = main_path.returncode != 0 and "chip_smoke FAILED" in main_path.stderr
        print(f"mutant {name}: kernel tests {'caught' if caught_tests else 'MISSED'} "
              f"({', '.join(f'{n} {k}' for n, k in tally) or tests.stdout[-300:]}); "
              f"main-path shape {'caught' if caught_main else 'MISSED'} ({reason})", flush=True)
        if not (caught_tests and caught_main):
            missed.append(name)
    shutil.rmtree(REPO / "vit_ae_plus_plus_torch" / "build" / "mutants", ignore_errors=True)
    if missed:
        print(f"kernel_mutants: not caught: {missed}", file=sys.stderr)
        return 1
    print(f"kernel_mutants: all {len(MUTANTS)} mutants caught")
    return 0


if __name__ == "__main__":
    sys.exit(main())
