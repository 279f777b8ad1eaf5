"""Share of the window's region loads whose pileup and pure-reference
flags the card built: the program's ``native.regions_card_built`` over it
and ``native.regions_host_built``.  None where the program has no such
counters (a program that builds every region on the host) or loaded no
region."""

KEYS = ("native.regions_card_built", "native.regions_host_built")


def read(run):
    stats = getattr(run, "stats", None) or {}
    if any(k not in stats for k in KEYS):
        return None
    card, host = (stats[k] for k in KEYS)
    return 100.0 * card / (card + host) if card + host else None
