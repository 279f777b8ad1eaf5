"""Columns both samples cover, summed over the genome windows the
window's passes finished, over the window's wall time (host clock)."""


def read(run):
    if getattr(run, "columns", None) is None:
        return None
    return run.columns / run.window_s
