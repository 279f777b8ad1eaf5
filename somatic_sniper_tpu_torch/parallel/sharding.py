"""The batch split over local devices, and the genome interval partition.

Port of somatic_sniper_tpu/parallel/sharding.py.  Pileup columns are
independent, so a batch splits along its leading axis with no
communication until the results are gathered.  The source hands the
split to GSPMD (a mesh, ``NamedSharding``, one jitted program); torch's
idiom is explicit, in two forms:

* ``graphed_split``, the route of a split slab and of every compact
  batch on cards (an unsplit one is a single part): the host upload cut
  into one equal part a device, each part scored by that device's
  captured step (``models.step_graph.STEP_GRAPHS.run_parts``: one
  replay a part, the counterpart of the one jitted program), the parts'
  compact rows gathered on the first device and merged there
  (``models.somatic.merge_compact``, eager: a few operations) into the
  unsplit step's rows with the global column index;
* ``sharded_call_batch``, eager, for the CPU and the full CallResult
  (the overflow refetch): one contiguous part a device (uneven parts
  allowed), each scored with ``models.somatic.call_batch`` on its
  device, with that device's tables and on a stream of its own, the
  results concatenated on the first device.

``make_mesh`` and ``shard_column_batch`` have no counterpart: a mesh is
a list of ``torch.device`` here, and a part is moved where it is scored.
``partition_intervals`` is copied as it was.

The same device may appear twice in the list: its parts then run one
after the other on that device (two streams eagerly, its capture stream
when captured, each part with a key and buffers of its own), which is
how a one-card machine (and, with ``cpu``, a machine with none)
exercises the split and the merge.  Parts on distinct cards (copies
between cards, streams that wait on another card's) run in
chip_smoke.py's ``--cards`` run, which needs two cards or more.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import step_graph
from ..models.glfgen import ColumnBatch
from ..models.somatic import (CallResult, CompactResult, call_batch,
                              merge_compact)
from ..models.tables import ModelParams


def split_bounds(B: int, n: int) -> list[tuple[int, int]]:
    """``n`` contiguous [lo, hi) spans covering ``range(B)``, sizes
    differing by at most one."""
    return [(i * B // n, (i + 1) * B // n) for i in range(n)]


def _part(cb: ColumnBatch, lo: int, hi: int, dev: torch.device,
          stream) -> ColumnBatch:
    """Rows [lo, hi) of a batch on ``dev``.  A slice that already lies
    there is read by ``stream`` where it is: the allocator is told."""
    def move(t):
        if t is None:
            return None
        t = t[lo:hi]
        if t.device == dev:
            if stream is not None:
                t.record_stream(stream)
            return t
        return t.to(dev, non_blocking=True)

    return ColumnBatch(*(move(t) for t in cb))


def sharded_call_batch(devices, tumor: ColumnBatch, normal: ColumnBatch,
                       dtabs_of, params: ModelParams,
                       precision: str = "fast") -> CallResult:
    """``call_batch`` with the batch axis split over ``devices``.

    ``devices`` is a list of ``torch.device`` (a device may repeat);
    ``dtabs_of(device)`` returns that device's DeviceTables of
    ``precision``.  The batches may lie on any device, the host
    included: each part is moved to the device that scores it.  Returns
    the CallResult on ``devices[0]``, every field equal to the unsplit
    call's (columns never interact)."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("sharded_call_batch: no devices")
    B = tumor.slots.shape[0]
    first = devices[0]
    spans = [(dev, lo, hi) for dev, (lo, hi)
             in zip(devices, split_bounds(B, len(devices))) if hi > lo]
    if not spans:  # an empty batch: nothing to split
        dev_batches = (_part(cb, 0, 0, first, None) for cb in (tumor, normal))
        return call_batch(*dev_batches, dtabs_of(first), params, precision)
    parts, streams = [], []
    for dev, lo, hi in spans:
        dtabs = dtabs_of(dev)
        if dev.type != "cuda":
            res = call_batch(_part(tumor, lo, hi, dev, None),
                             _part(normal, lo, hi, dev, None), dtabs, params,
                             precision)
            parts.append(tuple(None if f is None else f.to(first)
                               for f in res))
            continue
        stream = torch.cuda.Stream(dev)
        # the tables, and a part that already lies here, were written
        # on the device's current stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            res = call_batch(_part(tumor, lo, hi, dev, stream),
                             _part(normal, lo, hi, dev, stream), dtabs,
                             params, precision)
            # a copy to the first device is queued behind the part's
            # kernels, on this stream
            parts.append(tuple(None if f is None else f.to(first)
                               for f in res))
        streams.append(stream)
    if first.type == "cuda":
        cur = torch.cuda.current_stream(first)
        for stream in streams:
            cur.wait_stream(stream)
        for part in parts:
            for f in part:
                if f is not None:
                    f.record_stream(cur)
    else:
        for stream in streams:
            stream.synchronize()
    return CallResult(*(
        None if fs[0] is None
        # the error word: set if any part's is
        else torch.stack(fs).amax() if name == "err" else torch.cat(fs)
        for name, fs in zip(CallResult._fields, zip(*parts))))


def graphed_split(graphs, devices, stacked_h: np.ndarray,
                  meta_h: np.ndarray, dtabs_of, params: ModelParams,
                  spec) -> tuple[str, CompactResult]:
    """A slab or a batch, in its host upload layout ([2, B, D] lanes,
    metadata [R, B]), scored in ``len(devices)`` equal parts, each by
    its device's captured step in ``graphs`` (a ``models.step_graph
    .SlabStepGraph``) under ``spec`` (the slab step, or the batch step
    with ``max_emit`` K): one replay a part.  B must divide evenly, as
    the JAX package requires of its mesh.  ``dtabs_of(device)`` gives a
    device's tables.  Returns the route (``SlabStepGraph.run_parts``: a
    batch key's first call eager, its second captured, later ones
    replayed; a slab's captured at once) and the CompactResult on
    ``devices[0]`` with the rows of the unsplit step, global column
    index included (K = B for a slab).  A single device scores the
    whole as one part, with no merge: the unsplit batch's route.
    Nothing waits on the device."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    B = stacked_h.shape[1]
    if n == 0 or B % n:
        raise ValueError(f"graphed_split: {B} columns in {n} equal parts")
    part_b = B // n
    slab = spec.packed16 is None
    part_spec = spec if slab else spec._replace(
        max_emit=min(spec.max_emit, part_b))
    parts = [(dev, dtabs_of(dev), stacked_h[:, i * part_b:(i + 1) * part_b],
              meta_h[:, i * part_b:(i + 1) * part_b])
             for i, dev in enumerate(devices)]
    first = devices[0]
    route, outs = graphs.run_parts(parts, params, part_spec, first)
    if n == 1:
        return route, outs[0]
    with step_graph._device(first):
        return route, merge_compact(outs, part_b, B if slab else spec.max_emit)


def partition_intervals(
    ref_lengths: list[int], n_shards: int, min_chunk: int = 1
) -> list[list[tuple[int, int, int]]]:
    """Deterministic (tid, start, end) interval partition of a genome.

    Splits total genome length into ``n_shards`` near-equal contiguous
    spans following contig order — identical on every host, so shard
    assignment needs no communication.
    """
    total = sum(ref_lengths)
    bounds = [round(i * total / n_shards) for i in range(n_shards + 1)]
    shards: list[list[tuple[int, int, int]]] = [[] for _ in range(n_shards)]
    gpos = 0
    for tid, ln in enumerate(ref_lengths):
        for s in range(n_shards):
            lo = max(bounds[s], gpos)
            hi = min(bounds[s + 1], gpos + ln)
            if hi > lo:
                shards[s].append((tid, lo - gpos, hi - gpos))
        gpos += ln
    return shards
