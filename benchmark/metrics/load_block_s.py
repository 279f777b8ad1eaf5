"""Seconds of the program's ``STATS`` stage ``load_wait.block`` in the
window per million columns the window's passes covered: the main
thread's time blocked on a window's region loads (inside ``load_wait``,
without its polls, emits and the caller's time)."""


def read(run):
    if not getattr(run, "columns", None) or "load_wait.block" not in run.stats:
        return None
    return run.stats["load_wait.block"] / (run.columns / 1e6)
