"""Seconds of the program's ``STATS`` stage ``load_wait`` in the window per
million columns the window's passes covered."""


def read(run):
    if not getattr(run, "columns", None) or "load_wait" not in run.stats:
        return None
    return run.stats["load_wait"] / (run.columns / 1e6)
