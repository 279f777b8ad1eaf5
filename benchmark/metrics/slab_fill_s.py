"""Seconds of the program's ``STATS`` stage ``pad+dispatch`` in the window per
million columns the window's passes covered."""


def read(run):
    if not getattr(run, "columns", None) or "pad+dispatch" not in run.stats:
        return None
    return run.stats["pad+dispatch"] / (run.columns / 1e6)
