"""The byte bound of the columns the card scored (``roofline``: two
samples' kept lanes at the pair's mean depth, a reference byte and an
output row each, at the H100's 3.35 TB/s) over the traced window's
device busy time."""

import roofline


def read(run):
    n = (getattr(run, "stats", None) or {}).get("device_columns")
    if not n or not getattr(run, "busy_s", None):
        return None
    return 100.0 * roofline.bound_seconds(n, run.pair.mean_depth) / run.busy_s
