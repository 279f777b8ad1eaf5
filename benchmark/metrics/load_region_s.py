"""Thread-seconds of the program's ``STATS`` stage ``load.region`` in the
window per million columns the window's passes covered: every region
load of the load pool, a sample and a window each (the native load, and
at a contig's start the quirk carry's backward scan), summed over the
pool's threads."""


def read(run):
    if not getattr(run, "columns", None) or "load.region" not in run.stats:
        return None
    return run.stats["load.region"] / (run.columns / 1e6)
