"""Seconds of the program's ``STATS`` stage ``driver.open`` in the window
per million columns the window's passes covered: each pass's set-up in
the windowed driver, from its entry to its first window's loads (the
header, both indexes, the reference blob, the tables, the pool)."""


def read(run):
    if not getattr(run, "columns", None) or "driver.open" not in run.stats:
        return None
    return run.stats["driver.open"] / (run.columns / 1e6)
