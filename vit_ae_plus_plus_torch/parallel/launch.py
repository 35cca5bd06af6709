"""Run one function on every rank of a fresh torch.distributed world.

`run_ranks(fn, world_size, args, store_dir=...)` starts `world_size`
processes by the spawn method (never fork: the parent may hold CUDA and
threads), joins them in one gloo process group through a `file://` store in
`store_dir` (no TCP port, so parallel runs cannot collide), calls
`fn(rank, *args)` on each and returns their results in rank order. A rank
that raises, dies or outlives `timeout` fails the whole run: the others are
stopped and `run_ranks` raises. `fn` must be importable by name (a
module-level function) and return something that pickles by value (numbers,
strings, numpy arrays), since a rank may exit before its result is read.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch.distributed as dist


def _rank_main(rank, world_size, init_method, timeout, fn, args, results) -> None:
    try:
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *, store_dir: str,
              timeout: float = 600.0) -> List:
    """`[fn(0, *args), ..., fn(world_size - 1, *args)]`, each run on its own
    rank of a gloo process group; raises RuntimeError if a rank fails
    or the run outlives `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    os.makedirs(store_dir, exist_ok=True)
    init_method = f"file://{os.path.join(tempfile.mkdtemp(dir=store_dir), 'store')}"
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, init_method, timeout, fn, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out, failures = {}, []
    try:
        while len(out) + len(failures) < world_size:
            try:
                rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                failures.append(f"timed out after {timeout:.0f} s; ranks without a result: "
                                f"{sorted(set(range(world_size)) - set(out))}")
                break
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank} failed:\n{value}")
                break
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0) if not failures else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    bad = [f"rank {r} exit code {p.exitcode}" for r, p in enumerate(procs) if p.exitcode != 0]
    if failures or bad:
        raise RuntimeError("; ".join(failures + bad) or "ranks failed")
    return [out[r] for r in range(world_size)]
