"""Run one function on every rank of a fresh torch.distributed world.

`run_ranks(fn, world_size, args, store_dir=...)` starts `world_size`
processes by the spawn method (never fork: the parent may hold CUDA and
threads), joins them in one process group through a `file://` store in
`store_dir` (no TCP port, so parallel runs cannot collide), calls
`fn(rank, *args)` on each and returns their results in rank order. A rank
that raises, dies or outlives `timeout` fails the whole run: the others are
stopped and `run_ranks` raises. `fn` must be importable by name (a
module-level function) and return something that pickles by value (numbers,
strings, numpy arrays), since a rank may exit before its result is read.

The group is gloo by default: host memory, any number of ranks on one card
or on the CPU (what the tests and `chip_smoke.py` run). `backend="nccl"`
puts rank r on `cuda:r` (`torch.cuda.set_device(r)` before the group
forms), one rank per card, and raises before any spawn when the world has
more ranks than the process sees cards: NCCL refuses two ranks on one
device, and the launch never falls back to gloo.

`forward_signals` (the CLI's `serve --n-devices`): while the ranks run,
each of these signals that reaches the launching process is passed on to
rank 0, which decides how the run ends (a server drains, then stops the
other ranks).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _rank_main(rank, world_size, init_method, timeout, fn, args, results, backend) -> None:
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kw)
        try:
            results.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise


def _check_backend(backend: str, world_size: int) -> None:
    """Raise `ValueError` for an unknown backend, and `RuntimeError` for an
    NCCL world with more ranks than this process sees cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl" and world_size > torch.cuda.device_count():
        raise RuntimeError(
            f"{world_size} NCCL ranks need {world_size} CUDA devices (one rank per card), and this "
            f"process sees {torch.cuda.device_count()}; NCCL refuses two ranks on one device. Ask for "
            "at most that many devices, or run the ranks on the CPU (gloo) with device='cpu'.")


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), *, store_dir: str,
              timeout: Optional[float] = 600.0, backend: str = "gloo",
              forward_signals: Sequence[int] = ()) -> List:
    """`[fn(0, *args), ..., fn(world_size - 1, *args)]`, each run on its own
    rank of a `backend` process group; raises RuntimeError if a rank fails
    or dies, or the run outlives `timeout` seconds (None: no limit, and the
    collectives keep torch's default timeout). `forward_signals`: passed
    on to rank 0 while the ranks run (module docstring; from the main
    thread only)."""
    _check_backend(backend, world_size)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    os.makedirs(store_dir, exist_ok=True)
    store = tempfile.mkdtemp(dir=store_dir)
    init_method = f"file://{os.path.join(store, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, init_method, timeout, fn, tuple(args), results, backend))
             for r in range(world_size)]
    for p in procs:
        p.start()
    def forward(signum, _frame):
        if procs[0].is_alive():
            with contextlib.suppress(ProcessLookupError):
                os.kill(procs[0].pid, signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        previous = {sig: signal.signal(sig, forward) for sig in forward_signals}
    deadline = time.monotonic() + (timeout if timeout is not None else float("inf"))
    out, failures = {}, []
    try:
        while len(out) + len(failures) < world_size:
            try:
                rank, ok, value = results.get(timeout=max(min(deadline - time.monotonic(), 1.0), 0.01))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:  # killed without a word (a signal, out of memory)
                    failures.append(f"ranks {dead} died without a result")
                elif time.monotonic() >= deadline:
                    failures.append(f"timed out after {timeout:.0f} s; ranks without a result: "
                                    f"{sorted(set(range(world_size)) - set(out))}")
                else:
                    continue
                break
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank} failed:\n{value}")
                break
        for p in procs:
            p.join(timeout=1.0 if failures else None if timeout is None else max(deadline - time.monotonic(), 1.0))
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(store, ignore_errors=True)
    bad = [f"rank {r} exit code {p.exitcode}" for r, p in enumerate(procs) if p.exitcode != 0]
    if failures or bad:
        raise RuntimeError("; ".join(failures + bad) or "ranks failed")
    return [out[r] for r in range(world_size)]
