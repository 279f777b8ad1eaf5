"""CPU seconds of the run's process, every thread, in the window per
million columns the window's passes covered (``time.process_time``).
A contended host stretches the wall but less so this."""


def read(run):
    if not getattr(run, "columns", None) or getattr(run, "cpu_s", None) is None:
        return None
    return run.cpu_s / (run.columns / 1e6)
