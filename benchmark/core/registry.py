"""Finds the benchmark's parts by name, so that a new cell, configuration,
metric or kernel family is a new file and no code changes:

- a configuration: `configs/<name>.json`;
- a cell (its traffic, driver kind and correctness limits):
  `workloads/<name>.json`;
- a driver kind: `drivers/<kind>.py`, with `run(ctx) -> Run`;
- a metric's reader: `metrics/<metric>.py`, with `PHASE` ("end_to_end" or
  "per_layer"), `UNIT` and `read(run) -> float | None`;
- a kernel family: `kernel_families/<family>/*.txt`, one regular expression
  a line over the lower-cased device kernel name; a line `#priority N` sets
  the family's rank (lower first, default 50), other `#` lines are comments.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[1]

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    cfg = _load_json(root / "configs" / f"{_check_name(name)}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names itself {cfg.get('name')!r}")
    return cfg


def workload(name: str, root: Path = ROOT) -> dict:
    wl = _load_json(root / "workloads" / f"{_check_name(name)}.json")
    if wl.get("name") != name:
        raise ValueError(f"workloads/{name}.json names itself {wl.get('name')!r}")
    return wl


def workload_names(root: Path = ROOT) -> List[str]:
    return sorted(p.name[: -len(".json")] for p in (root / "workloads").glob("*.json"))


def _module(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    path = root / "drivers" / f"{_check_name(kind)}.py"
    if not path.exists():
        raise FileNotFoundError(f"no driver kind {kind!r} ({path})")
    return _module(path, "driver")


def metric_readers(root: Path = ROOT) -> Dict[str, ModuleType]:
    """Every reader under metrics/, by metric name (the file's stem)."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        name = path.name[: -len(".py")]
        mod = _module(path, "metric")
        if getattr(mod, "PHASE", None) not in ("end_to_end", "per_layer"):
            raise ValueError(f"metrics/{path.name}: PHASE must be 'end_to_end' or 'per_layer'")
        out[_check_name(name)] = mod
    return out


def kernel_families(root: Path = ROOT) -> List[Tuple[str, List[re.Pattern]]]:
    """[(family, patterns)] in rank order; the first family with a matching
    pattern owns a kernel."""
    fams = []
    for d in sorted(p for p in (root / "kernel_families").iterdir() if p.is_dir()):
        priority, pats = 50, []
        for f in sorted(d.glob("*.txt")):
            for line in f.read_text().splitlines():
                line = line.strip()
                m = re.match(r"^#\s*priority\s+(\d+)\s*$", line)
                if m:
                    priority = int(m.group(1))
                elif line and not line.startswith("#"):
                    pats.append(re.compile(line))
        fams.append((priority, d.name, pats))
    return [(name, pats) for _, name, pats in sorted(fams)]


def family_of(kernel: str, families) -> str:
    low = kernel.lower()
    if low.startswith("void "):
        low = low[5:]
    for name, pats in families:
        if any(p.search(low) for p in pats):
            return name
    return "other"
