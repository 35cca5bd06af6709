"""The window's analytic step FLOPs (benchmark/core/flops.py) over its
time, as a share of the chip's dense peak for the step's dtype (989
TFLOP/s bf16, 495 TF32 for f32 steps; H100 SXM data sheet, 700 W)."""

from benchmark.core import flops

PHASE = "per_layer"
UNIT = "%"


def read(run):
    if run["kind"] != "train":
        return None
    work = flops.mae_step_flops(run["cfg"], run["batch"])["total"] * run["steps"]
    return 100.0 * work / run["window_s"] / flops.PEAK_FLOPS[run["dtype"]]
