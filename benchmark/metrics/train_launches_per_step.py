"""Device kernels a step: the kernel events of the traced steps over their
number (copies and fills not counted)."""

PHASE = "per_layer"
UNIT = "launches"


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or not tr.kernels():
        return None
    return len(tr.kernels()) / run["profile_steps"]
