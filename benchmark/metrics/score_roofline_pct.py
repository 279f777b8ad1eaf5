"""The byte bound of the columns the card scored (``roofline``: two
samples' kept lanes at the pair's mean depth, a reference byte and an
output row each, at the H100's 3.35 TB/s) over the device time of the
scoring step in the traced window: every device operation but the BGZF
inflate, the copies and the memsets, that is the step's hand-written
kernels (glfgen, accumulate, assembly10, score_columns) with torch's
kernels of the c_tot > 255 rescale.  It is the window's summed device
time (``device_op_s``) less the inflate's and the copies' entries of the
breakdown, which lists the ten longest operations, so that an operation
of the step outside those ten is still counted (a copy outside them is
counted too, which can only lower the share).  None where no hand-written
scoring kernel is listed or the summed device time is missing."""

import re

import roofline

SCORING = re.compile(r"(glfgen\w*|accumulate\w*|assembly10|score_columns)_kernel")
NOT_STEP = re.compile(r"bgzf_inflate|^Memcpy|^Memset")


def read(run):
    n = (getattr(run, "stats", None) or {}).get("device_columns")
    ops = (getattr(run, "breakdown", None) or {}).get("device_ops") or []
    total = getattr(run, "device_op_s", None)
    if not n or total is None or not any(SCORING.search(name) for name, _ in ops):
        return None
    secs = total - sum(s for name, s in ops if NOT_STEP.search(name))
    if secs <= 0:
        return None
    return 100.0 * roofline.bound_seconds(n, run.pair.mean_depth) / secs
