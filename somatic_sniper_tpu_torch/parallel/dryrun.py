"""Entry points on tiny shapes: the single-device forward step and the
dry run of the multi-device path.

Port of the JAX package's ``__graft_entry__.py``.  ``entry`` (:32-59)
gives ``(fn, example_args)``: the fast ``call_batch`` on two tiny
full-u32 batches on the device, which launches ``glfgen`` on a card.
``dryrun_multichip`` (:62-154): the batch split on a tiny batch against
the unsplit call, the interval partition, then the golden pair through
``call_pair`` with the production dispatch split over the devices, once
at the default slab size and once at ``SNIPER_SLAB_B=1023`` (a slab that
does not divide goes unsplit, and must give the same lines).

    python -c "from somatic_sniper_tpu_torch.parallel.dryrun import \\
        dryrun_multichip; dryrun_multichip(2, 'cpu')"
    python -c "from somatic_sniper_tpu_torch.parallel.dryrun import \\
        entry; fn, args = entry('cpu'); print(int(fn(*args).emit.sum()))"
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.glfgen import ColumnBatch, pack_slots_np
from ..models.somatic import call_batch
from ..models.tables import ModelParams, build_tables, device_tables
from ..runner import call_pair, data_mesh, dtabs_for, forced_mesh
from ..utils.stats import STATS
from .sharding import partition_intervals, sharded_call_batch
from .slab import slab_b

GOLDEN = Path(__file__).resolve().parents[2] / "tests" / "data"


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


def mesh_devices(n_devices: int, device: str = "cuda") -> list[torch.device]:
    """``cuda:0..n-1``, raising when the machine has fewer GPUs; only
    ``device="cpu"`` by name gives ``n`` CPU parts."""
    if device == "cpu":
        return [torch.device("cpu")] * n_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} GPUs, this "
            f"machine has {have}; device='cpu' runs the split in CPU parts")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """Run the split scoring step over ``n_devices`` devices on tiny
    shapes and hold it to the unsplit call; raises on any difference."""
    devices = mesh_devices(n_devices, device)
    params = ModelParams(use_joint_priors=True)
    dtabs_of = dtabs_for(params, "fast")
    # one batch that divides by the devices and one that does not
    emitted = 0
    for B in (16 * n_devices, 16 * n_devices + 3):
        tb, nb = tiny_batch(B, 16, seed=1), tiny_batch(B, 16, seed=2)
        split = sharded_call_batch(devices, tb, nb, dtabs_of, params)
        whole = call_batch(
            ColumnBatch(*(t.to(devices[0]) for t in tb[:3])),
            ColumnBatch(*(t.to(devices[0]) for t in nb[:3])),
            dtabs_of(devices[0]), params)
        for name, a, b in zip(whole._fields, split, whole):
            if a is None and b is None:
                continue
            if a.shape != (B,) or not torch.equal(a, b):
                raise AssertionError(
                    f"split over {n_devices} devices differs from the "
                    f"unsplit call in {name} at B={B}")
        emitted += int(split.emit.sum())
    shards = partition_intervals([3000, 2000], n_devices)
    if len(shards) != n_devices:
        raise AssertionError("partition_intervals lost a shard")

    # the production step over the mesh: call_pair's dispatch splits
    # every slab over the devices (runner.data_mesh)
    n_recs = -1
    if (GOLDEN / "t-small.bam").exists():
        args = (str(GOLDEN / "t-small.bam"), str(GOLDEN / "n-small.bam"),
                str(GOLDEN / "small.fa"), "vcf")
        kw = dict(precision="fast", device=devices[0])
        saved = {k: os.environ.get(k)
                 for k in ("SNIPER_DEVICE_MIN_COLS", "SNIPER_SLAB_B")}
        # the tiny pair must reach the device: covering it is the point
        os.environ["SNIPER_DEVICE_MIN_COLS"] = "0"
        os.environ.pop("SNIPER_SLAB_B", None)
        try:
            unsplit = list(call_pair(*args, **kw))
            with forced_mesh(devices):
                if data_mesh(devices[0]) != devices:
                    raise AssertionError("the mesh is not in force")
                STATS.reset()
                recs = list(call_pair(*args, **kw))
                if (slab_b() % n_devices == 0
                        and not STATS.snapshot().get("slabs_split")):
                    raise AssertionError("no slab was split over the mesh")
                os.environ["SNIPER_SLAB_B"] = "1023"
                recs_fb = list(call_pair(*args, **kw))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        n_recs = len(recs)
        if n_recs < 1 or recs != unsplit:
            raise AssertionError("the split run's lines differ from the "
                                 "unsplit run's")
        if recs_fb != recs:
            raise AssertionError("the unsplit-slab fallback diverged")
    print(f"dryrun_multichip ok: {n_devices} devices "
          f"({', '.join(sorted({str(d) for d in devices}))}), "
          f"{emitted} emitted, e2e records {n_recs}")
