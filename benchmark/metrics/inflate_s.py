"""Thread-seconds of the native loader's read, BGZF block scan and
inflate phases (the program's ``STATS`` entries ``native.read``,
``native.bgzf_scan``, ``native.inflate``) in the window per million
columns the window's passes covered."""

PHASES = ("native.read", "native.bgzf_scan", "native.inflate")


def read(run):
    if not getattr(run, "columns", None) or any(
            p not in run.stats for p in PHASES):
        return None
    return sum(run.stats[p] for p in PHASES) / (run.columns / 1e6)
