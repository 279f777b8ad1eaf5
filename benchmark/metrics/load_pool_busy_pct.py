"""Share of the load pool's thread time that ran tasks in the window:
the program's ``STATS`` stage ``load_pool.busy`` (the wall time of every
task the pool ran) over ``load_pool.open`` (the pool's threads times its
open wall), in percent."""


def read(run):
    busy = run.stats.get("load_pool.busy")
    opened = run.stats.get("load_pool.open")
    if busy is None or not opened:
        return None
    return 100.0 * busy / opened
