"""The share of the traced steps' wall time that no device kernel, copy or
fill covers."""

PHASE = "per_layer"
UNIT = "%"


def read(run):
    tr = run.get("trace")
    if run["kind"] != "train" or tr is None or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
