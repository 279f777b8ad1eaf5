"""Summed time of every device operation in the traced window over the
program's ``slabs_dispatched``: device milliseconds a slab step."""


def read(run):
    n = (getattr(run, "stats", None) or {}).get("slabs_dispatched")
    if not n or not getattr(run, "device_op_s", None):
        return None
    return 1e3 * run.device_op_s / n
