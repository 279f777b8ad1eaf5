"""The single-device forward step on tiny shapes.

Port of the JAX package's ``__graft_entry__.py``.  ``entry`` (:32-59)
gives ``(fn, example_args)``: the fast ``call_batch`` on two tiny
full-u32 batches on the device, which launches ``glfgen`` on a card.
The JAX package's ``dryrun_multichip`` has no counterpart: a process of
the port scores on one device, and several GPUs are reached through
several processes (``--shards`` / ``--jobs``, see ``runner``).

    python -c "from somatic_sniper_tpu_torch.parallel.dryrun import \\
        entry; fn, args = entry('cpu'); print(int(fn(*args).emit.sum()))"
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.glfgen import ColumnBatch, pack_slots_np
from ..models.somatic import call_batch
from ..models.tables import ModelParams, build_tables, device_tables


def tiny_batch(B: int = 64, D: int = 32, seed: int = 0) -> ColumnBatch:
    """A random full-u32 batch on the host (``_tiny_batch`` of the
    source, :8-29)."""
    rng = np.random.default_rng(seed)
    depths = rng.integers(1, D, B).astype(np.int32)
    slots = pack_slots_np(
        rng.choice([1, 2, 4, 8, 15], size=(B, D)),
        rng.integers(0, 60, (B, D)),
        rng.integers(0, 61, (B, D)),
        rng.integers(0, 2, (B, D)),
        rng.random((B, D)) < 0.02,
    )
    slots = np.where(np.arange(D)[None, :] < depths[:, None], slots, 0)
    ref16 = rng.choice([1, 2, 4, 8], size=B).astype(np.int32)
    return ColumnBatch(
        slots=torch.from_numpy(slots.astype(np.uint32).view(np.int32)),
        depth=torch.from_numpy(depths), ref16=torch.from_numpy(ref16))


def entry(device=None):
    """``(fn, example_args)``: the forward step of the fast path, batched
    tumor/normal scoring over pileup columns in f32, on two tiny
    full-u32 batches (``tiny_batch`` seeds 1 and 2) with the default
    model and no joint priors (``entry`` of the source, :32-59).

    The batches and the tables lie on ``device``: the card when None
    (``resolve_device("cuda")`` raises without one), the CPU only by
    name.  ``fn(*example_args)`` returns the CallResult on that device;
    on a card each call launches ``glfgen`` twice."""
    dev = resolve_device("cuda" if device is None else device)
    params = ModelParams()
    dtabs = device_tables(build_tables(params), dev, "fast")
    tb, nb = (ColumnBatch(*(t.to(dev) for t in tiny_batch(seed=seed)[:3]))
              for seed in (1, 2))

    def fn(tb, nb):
        return call_batch(tb, nb, dtabs, params, precision="fast")

    return fn, (tb, nb)
