"""The allocator's peak over the window (`torch.cuda.max_memory_allocated`
after a reset at its start)."""

PHASE = "per_layer"
UNIT = "GiB"


def read(run):
    if run["kind"] != "train" or not run.get("peak_window_bytes"):
        return None
    return run["peak_window_bytes"] / 2 ** 30
