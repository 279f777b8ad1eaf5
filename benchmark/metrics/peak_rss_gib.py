"""Peak resident memory of the run's process over the window, sampled
from /proc/self/statm at 20 Hz."""


def read(run):
    if not getattr(run, "rss_peak", None):
        return None
    return run.rss_peak / 2**30
