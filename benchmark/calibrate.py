"""The readings that a cell's correctness limits are set from, for many seeds
in one process: the program's own numbers, the control's (the reference
put in the program's place with its products' operands one precision
below the configuration's: the workload's `control`) and each planted
fault's (`core/faults.py`).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--faults half_batch,...] [--fault-seeds ...] [--out FILE]

No window is needed: each seed builds the program's training state, runs
its three checked steps and compares them with the reference's. One JSON
line a seed and kind; `--out` also appends them to FILE.
"""

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=_seeds, default=None)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    from benchmark.core import runner

    for line in readings(args.workload, args.seeds, args.control_seeds,
                         [f for f in args.faults.split(",") if f], args.fault_seeds, args.device):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    if runner.jax_modules(sys.modules):
        sys.exit(f"JAX was loaded: {runner.jax_modules(sys.modules)}")


def readings(name, seeds, control_seeds, faults, fault_seeds=None, device="cuda:0", root=None):
    """Yield {'workload', 'seed', 'kind' ('program' | 'control' | a fault),
    'numbers', 'seconds'} for each seed and kind."""
    import contextlib

    from benchmark.core import compare, faults as planted, registry, runner

    root = root or registry.ROOT
    fault_seeds = control_seeds if fault_seeds is None else fault_seeds
    plan = [(s, "program") for s in seeds] + [(s, "control") for s in control_seeds]
    plan += [(s, f) for f in faults for s in fault_seeds]
    ref_cache = {}  # seed -> the f32 reference's readings
    for seed, kind in plan:
        ctx = runner.make_ctx(name, seed, 0.0, False, device, time.perf_counter(), root)
        drv = registry.driver(ctx.workload["driver"], root)
        t = time.perf_counter()
        if kind == "control":
            prog = drv.reference_readings(ctx, ctx.workload["control"])
        else:
            with planted.plant(kind) if kind != "program" else contextlib.nullcontext():
                built = drv.build(ctx)
                prog = built["readings"]
                del built
            drv.free(ctx.device)
        if seed not in ref_cache:
            ref_cache[seed] = drv.reference_readings(ctx)
        numbers = compare.train_numbers(prog, ref_cache[seed])
        yield {"workload": name, "seed": seed, "kind": kind, "seconds": time.perf_counter() - t,
               "numbers": numbers}


if __name__ == "__main__":
    main()
