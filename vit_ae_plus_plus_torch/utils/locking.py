"""Single-writer work-dir lock for the training pipelines.

The port's copy of the JAX package's utils/locking.py. Two training
processes sharing one work dir overwrite each other's checkpoints, logs and
feature files, last writer wins; the lock refuses the second one loudly.

Mechanism: ``flock(LOCK_EX | LOCK_NB)`` on ``<work_dir>/.writer.lock``,
held for the duration of the pipeline. flock is kernel-atomic (no
check-then-create race between two simultaneous launches) and is released
when the holding process dies, so a killed run leaves no stale lock and
resumes with no manual cleanup. The file's JSON payload (pid, start time)
only names the holder in the refusal message; a leftover file with no
active flock locks nothing.

Semantics
---------
* :func:`locked_workdir` decorates a pipeline entry taking a ``work_dir``
  argument: the lock is taken before the body runs (before any config or
  data is touched) and released in ``finally``.
* Acquisition is re-entrant within one process (per-path hold count): the
  k-fold pipelines are chained in one process and tests call them
  repeatedly; an inner hold released by ``finally`` does not drop an outer
  one. The hold table is guarded by a ``threading.Lock``: two threads that
  take one dir at once must both see the other's hold, where an unguarded
  check-then-act would let both miss it and the second flock refuse its
  own process.
* A second live holder raises :class:`WorkdirLockedError` naming the
  holder's pid and the remediation.

Scope: single host (flock does not span NFS reliably).
"""
from __future__ import annotations

import fcntl
import functools
import inspect
import json
import os
import threading
import time
from typing import Dict

_LOCK_NAME = ".writer.lock"
# realpath -> [fd, hold_count]; the open fd IS the lock
_held: Dict[str, list] = {}
_held_lock = threading.Lock()


class WorkdirLockedError(RuntimeError):
    """Another live process holds the work-dir writer lock."""


def _lock_path(work_dir: str) -> str:
    return os.path.join(work_dir, _LOCK_NAME)


def acquire_workdir_lock(work_dir: str) -> None:
    """Take (or re-enter) the single-writer flock on ``work_dir``.

    Raises :class:`WorkdirLockedError` if another live process holds it.
    """
    os.makedirs(work_dir, exist_ok=True)
    key = os.path.realpath(work_dir)
    with _held_lock:
        if key in _held:
            _held[key][1] += 1
            return
        fd = os.open(_lock_path(work_dir), os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            holder = "unknown pid"
            try:
                held = json.loads(os.read(fd, 4096) or b"{}")
                holder = f"pid {held.get('pid', '?')} (started {held.get('started', '?')})"
            except ValueError:
                pass
            os.close(fd)
            raise WorkdirLockedError(
                f"work dir {work_dir!r} is locked by live {holder}. Two training "
                "processes sharing one work dir overwrite each other's checkpoints "
                "(checkpoint-min_loss.pth, the resume checkpoint), log.txt and feature "
                "files. Wait for that run or point this one at a different --work-dir. "
                "(The lock is a kernel flock: it vanishes with its process, so it is "
                "never stale.)"
            ) from None
        # record the hold FIRST: if the diagnostic write below failed after the
        # flock was won (e.g. ENOSPC), an unrecorded fd would wedge this process
        # out of its own lock for the rest of its lifetime
        _held[key] = [fd, 1]
        try:
            payload = json.dumps(
                {"pid": os.getpid(), "started": time.strftime("%Y-%m-%dT%H:%M:%S")}
            ).encode()
            os.ftruncate(fd, 0)
            os.pwrite(fd, payload, 0)
        except OSError:
            pass  # payload is purely diagnostic; the flock itself is the lock


def release_workdir_lock(work_dir: str) -> None:
    """Drop one hold; the flock is released when the count reaches zero.

    No-op if this process does not hold the lock. The lock file itself is
    left in place deliberately: unlinking it would let a racer flock the
    old inode while a third process creates-and-flocks a fresh file —
    two winners. A file with no active flock locks nothing.
    """
    key = os.path.realpath(work_dir)
    with _held_lock:
        entry = _held.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] > 0:
            return
        fd, _ = _held.pop(key)
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


def locked_workdir(fn):
    """Hold the work-dir writer lock for the duration of ``fn``.

    ``fn`` must take a ``work_dir`` argument (positionally or by keyword).
    The lock is acquired BEFORE the body runs — a locked dir is refused
    before any config or data is touched — and released in ``finally``.
    """
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        work_dir = sig.bind_partial(*args, **kwargs).arguments["work_dir"]
        acquire_workdir_lock(work_dir)
        try:
            return fn(*args, **kwargs)
        finally:
            release_workdir_lock(work_dir)

    return wrapper
