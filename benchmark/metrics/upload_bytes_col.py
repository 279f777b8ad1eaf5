"""Bytes of lanes and metadata the window's slabs uploaded, padding
included, per column the card scored: the program's
``slab_bytes_uploaded`` counter over its ``device_columns``.  None where
the program has no such counter or the card scored nothing."""


def read(run):
    stats = getattr(run, "stats", None) or {}
    if "slab_bytes_uploaded" not in stats or not stats.get("device_columns"):
        return None
    return stats["slab_bytes_uploaded"] / stats["device_columns"]
