"""Set-up: from the process's start to the first timed step
(loading, weights, warm-up, and in a checkout's first run the kernels'
build). Every cell."""

PHASE = "end_to_end"
UNIT = "s"


def read(run):
    return run["setup_s"]
