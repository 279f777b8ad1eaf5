"""Seconds from the harness's start to the window: the pair made from
the seed, imports, CUDA context, tables, the kernels' library, and one
warm-up pass (host clock)."""


def read(run):
    return run.setup_s
