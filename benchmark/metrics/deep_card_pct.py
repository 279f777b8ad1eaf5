"""Share of the window's columns that the card scored in slabs deeper
than 255 (the slab tiers that take the wide metadata and the c_tot > 255
rescale): the program's ``device_columns_deep`` counter over the columns
the passes covered.  None where the program has no such counter."""


def read(run):
    stats = getattr(run, "stats", None) or {}
    if not getattr(run, "columns", None) or "device_columns_deep" not in stats:
        return None
    return 100.0 * stats["device_columns_deep"] / run.columns
