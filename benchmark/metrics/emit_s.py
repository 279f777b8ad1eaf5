"""Seconds of the program's ``STATS`` stage ``emit`` in the window per
million columns the window's passes covered."""


def read(run):
    if not getattr(run, "columns", None) or "emit" not in run.stats:
        return None
    return run.stats["emit"] / (run.columns / 1e6)
