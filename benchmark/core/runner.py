"""One run of one cell: load its workload and configuration, run its driver
kind, read its metrics, judge `correct` and build the result line."""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from benchmark.core import compare, registry

JAX_ROOTS = ("jax", "jaxlib", "flax", "vit_ae_plus_plus_tpu")
N_BREAKDOWN = 10


@dataclass
class Ctx:
    cfg: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # the process's start on the host clock (time.perf_counter)

    @property
    def traffic(self) -> dict:
        return self.workload["traffic"]


def make_ctx(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             root: Path = registry.ROOT) -> Ctx:
    wl = registry.workload(name, root)
    return Ctx(cfg=registry.config(wl["config"], root), workload=wl, seed=int(seed),
               seconds=float(seconds), trace=bool(trace), device=torch.device(device), t_start=t_start)


def breakdown(run: dict, families) -> Optional[dict]:
    """The traced slice's device time by kernel family and its longest idle
    gaps named by the host call under each, at most ten of each."""
    tr = run.get("trace")
    if tr is None or not tr.device:
        return None
    by_family = {}
    for e in tr.device:
        fam = registry.family_of(e["name"], families)
        by_family[fam] = by_family.get(fam, 0.0) + e["dur"] / 1e6
    ops = sorted(by_family.items(), key=lambda kv: -kv[1])[:N_BREAKDOWN]
    gaps = sorted(tr.idle_gaps(), key=lambda g: g[0] - g[1])[:N_BREAKDOWN]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[tr.host_at((a + b) / 2), (b - a) / 1e6] for a, b in gaps]}


def jax_modules(modules) -> list:
    return sorted({m.split(".")[0] for m in modules} & set(JAX_ROOTS))


def result(ctx: Ctx, run: dict, root: Path = registry.ROOT) -> dict:
    """The contract's last line (without the JAX check, which the entry
    makes) and the checks, from a driver's run record."""
    run["families"] = families = registry.kernel_families(root)
    phase = "per_layer" if ctx.trace else "end_to_end"
    metrics = {}
    for name, reader in registry.metric_readers(root).items():
        if reader.PHASE != phase:
            continue
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    correct, checks = compare.judge(run["numbers"], ctx.workload["limits"])
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(run["memory_peak_bytes"])}
    line = {"correct": bool(correct and run["failed"] == 0), "attempted": int(run["attempted"]),
            "failed": int(run["failed"]), "metrics": metrics, "device": device}
    tr = run.get("trace")
    if tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        bd = breakdown(run, families)
        if bd:
            line["breakdown"] = bd
    line["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]} for k, v in checks.items()}
    return line


def _num(v: float):
    return v if math.isfinite(v) else str(v)

