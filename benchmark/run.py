"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`. The run loads and warms up
the program, measures for `--seconds`, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output; each number compared is also printed beside its limit
as the last lines of standard error. It needs an NVIDIA GPU, and exits
with an error and no result without one, or when the port
(`vit_ae_plus_plus_torch`, beside this directory) is missing, or when JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _fail(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout; the port builds its
    own libraries into vit_ae_plus_plus_torch/build/."""
    cache = CHECKOUT / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    _cache_dirs()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from benchmark.core import registry, runner

    wl = registry.workload(args.workload)
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on an NVIDIA GPU only")
    if torch.cuda.device_count() < int(wl["chips"]):
        _fail(f"the cell asks for {wl['chips']} GPUs, {torch.cuda.device_count()} are visible")
    try:
        import vit_ae_plus_plus_torch
    except ImportError as e:
        _fail(f"the port is missing from the checkout: {e}")
    if Path(vit_ae_plus_plus_torch.__file__).resolve().parents[1] != CHECKOUT:
        _fail(f"vit_ae_plus_plus_torch was imported from {vit_ae_plus_plus_torch.__file__}, not this checkout")

    ctx = runner.make_ctx(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    run = registry.driver(wl["driver"]).run(ctx)
    line = runner.result(ctx, run)
    loaded = runner.jax_modules(sys.modules)
    if loaded:
        _fail(f"modules of JAX or the JAX package were loaded: {loaded}")
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
