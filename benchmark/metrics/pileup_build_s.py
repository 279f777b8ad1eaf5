"""Thread-seconds of the native loader's record scan, pileup build and
pure-reference flag phases (the program's ``STATS`` entries
``native.record_scan``, ``native.pileup_build``, ``native.pure_flags``)
in the window per million columns the window's passes covered."""

PHASES = ("native.record_scan", "native.pileup_build", "native.pure_flags")


def read(run):
    if not getattr(run, "columns", None) or any(
            p not in run.stats for p in PHASES):
        return None
    return sum(run.stats[p] for p in PHASES) / (run.columns / 1e6)
