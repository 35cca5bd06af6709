"""A traced slice of a run: `torch.profiler` over a callable, reduced to what
the per-layer readers need.

On the card only the device's activity is traced (kernels, copies, fills
and the host's CUDA calls): recording every host operator as well doubles
the host's time a step and so invents idle time that untraced runs do not
have. The window is bounded on the device's own timeline by two marker
kernels (`torch.cuda._sleep`, named `spin_kernel`), launched right after
the device synchronisation that opens the slice and right before the one
that closes it. Markers are left out of every count. Without a card (the tests), host operators are traced instead,
inside a `bench_window` annotation.

The Chrome trace is exported to a temporary file (in TMPDIR, removed at
once) and reduced to a `Trace`, all times in microseconds.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench_window"
WINDOW_MARKER = re.compile(r"spin_kernel")
MARKER_CYCLES = 1000


@dataclass
class Trace:
    start: float  # the window, us
    end: float
    device: List[dict] = field(default_factory=list)  # {'name', 'cat', 'ts', 'dur'}, markers left out
    host: List[Tuple[float, float, str]] = field(default_factory=list)  # (start, end, name) of host calls

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        spans = sorted((max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end)) for e in self.device)
        out: List[Tuple[float, float]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e["cat"] == "kernel"]

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost traced host call running at time t (any thread)."""
        best: Optional[Tuple[float, str]] = None
        for a, b, name in self.host:
            if a <= t <= b and (best is None or b - a < best[0]):
                best = (b - a, name)
        return best[1] if best else "host, no CUDA call"


def parse(events: List[dict]) -> Trace:
    xs = [e for e in events if e.get("ph") == "X"]
    marks = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in xs
             if e.get("cat") == "kernel" and WINDOW_MARKER.search(e.get("name", ""))]
    if len(marks) >= 2:
        tr = Trace(start=min(a for a, _ in marks), end=max(b for _, b in marks))
    else:
        win = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError("the trace holds neither window markers nor the window annotation")
        tr = Trace(start=float(win[0]["ts"]), end=float(win[0]["ts"]) + float(win[0]["dur"]))
    for e in xs:
        cat, name = e.get("cat"), e.get("name", "?")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if WINDOW_MARKER.search(name):
                continue
            if ts < tr.end and ts + dur > tr.start:
                tr.device.append({"name": name, "cat": cat, "ts": ts, "dur": dur})
        elif cat in HOST_CATS:
            tr.host.append((ts, ts + dur, name))
    return tr


def profile(fn: Callable[[], None]) -> Trace:
    """Run fn under torch.profiler and return its reduced trace (module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile as _profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with _profile(activities=acts) as prof:
        with record_function(WINDOW):
            sync()
            if cuda:
                torch.cuda._sleep(MARKER_CYCLES)
            fn()
            if cuda:
                torch.cuda._sleep(MARKER_CYCLES)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return parse(data["traceEvents"] if isinstance(data, dict) else data)
