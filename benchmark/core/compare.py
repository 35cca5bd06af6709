"""The numbers that decide `correct`, each against the limit its cell's
workload file gives it.

Training: the program's first three steps against the reference's on the
same weights, volumes and masking noise.
- `loss_gap`: the largest relative gap of a step's loss;
- `grad_norm_gap`: by the worst leaf, the gap between the program's and
  the reference's norm of the first step's gradient (the program's as its
  optimizer holds it: the first moment after one step over (1 - b1)),
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- `change_norm_gap`: the same for each leaf's change over the three steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

SILENT_GRAD = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float], names) -> tuple:
    names = list(names)
    med = float(np.median([ref[n] for n in names]))
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    g, g_leaf = _worst_leaf(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    med = float(np.median(list(ref["grad_norms"].values())))
    moving = [n for n, v in ref["grad_norms"].items() if v >= SILENT_GRAD * med]
    c, c_leaf = _worst_leaf(prog["change_norms"], ref["change_norms"], moving)
    return {"loss_gap": {"value": max(losses), "at": f"step {losses.index(max(losses)) + 1}"},
            "grad_norm_gap": {"value": g, "at": g_leaf},
            "change_norm_gap": {"value": c, "at": c_leaf}}


def judge(numbers: Dict[str, dict], limits: Dict[str, float]) -> tuple:
    """(correct, checks): every number finite and at most its limit;
    checks {name: {'value', 'limit'}} in the limits' order."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]["value"]
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
