"""Share of the window's columns that the card scored: the program's
``device_columns`` counter over the columns the passes covered."""


def read(run):
    if not getattr(run, "columns", None) or "device_columns" not in run.stats:
        return None
    return 100.0 * run.stats["device_columns"] / run.columns
