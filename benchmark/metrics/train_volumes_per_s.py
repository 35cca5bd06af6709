"""Volumes trained a second: every batch row of every step completed in the
window, over the window, which ends in a device synchronisation."""

PHASE = "end_to_end"
UNIT = "volumes/s"


def read(run):
    if run["kind"] != "train":
        return None
    return run["volumes"] / run["window_s"]
