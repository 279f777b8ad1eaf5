"""Builds both native host libraries once, before any test process loads
them.

``somatic_sniper_tpu/io/native`` and ``somatic_sniper_tpu_torch/io/native``
each build ``libsniper_native.so`` with g++ at first use.  Under
pytest-xdist every worker that finds a library missing or stale builds
it, and the JAX package's loader writes the file in place: a worker that
maps it half-written keeps no library for its life, and every test of
its files that needs native code fails.  Here the controlling pytest
process builds both, on two threads, before xdist starts its workers,
so each worker finds a whole, fresh library and builds nothing.

It sits at the repository's root, not in ``tests/conftest.py``, because
that file configures JAX for the suite and is left as it is.  It sets no
environment variable, adds no option and changes no collection.  Without
g++ each ``get_lib()`` returns None as it would inside a test.
"""

import threading


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built both
    from somatic_sniper_tpu.io import native as jax_native
    from somatic_sniper_tpu_torch.io import native as torch_native

    builds = [threading.Thread(target=m.get_lib)
              for m in (jax_native, torch_native)]
    for t in builds:
        t.start()
    for t in builds:
        t.join()
