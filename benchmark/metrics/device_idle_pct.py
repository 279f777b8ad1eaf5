"""Share of the traced window in which no kernel, copy or set runs on
the device (the union of the trace's device intervals)."""


def read(run):
    if not getattr(run, "busy_s", None):
        return None
    return 100.0 * (run.window_s - run.busy_s) / run.window_s
