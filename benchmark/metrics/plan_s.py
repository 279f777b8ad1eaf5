"""Seconds of the program's ``STATS`` stage ``plan`` in the window per
million columns the window's passes covered."""


def read(run):
    if not getattr(run, "columns", None) or "plan" not in run.stats:
        return None
    return run.stats["plan"] / (run.columns / 1e6)
