"""The attention kernels' share of their roofline over the traced steps:
the least time of the steps' attention work (forward and backward, no
recomputation; benchmark/core/flops.py) over the summed time of the
`attention` family's kernels."""

from benchmark.core import flops, registry

PHASE = "per_layer"
UNIT = "%"


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None:
        return None
    spent = sum(e["dur"] for e in tr.kernels() if registry.family_of(e["name"], run["families"]) == "attention")
    if spent <= 0:
        return None
    calls = flops.attention_calls(run["cfg"], run["batch"])
    least = flops.attention_least_seconds(calls, run["dtype"], backward=True) * run["profile_steps"]
    return 100.0 * least / (spent / 1e6)
