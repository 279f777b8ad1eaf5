"""The batch split over local devices, and the genome interval partition.

Port of somatic_sniper_tpu/parallel/sharding.py.  Pileup columns are
independent, so a batch splits along its leading axis with no
communication until the results are gathered.  The source hands the
split to GSPMD (a mesh, ``NamedSharding``, one jitted program); torch's
idiom is explicit: ``sharded_call_batch`` cuts the batch into one
contiguous part a device (uneven parts allowed), scores each part with
``models.somatic.call_batch`` on its device, with that device's tables
and on a stream of its own, and concatenates the results on the first
device.  ``make_mesh`` and ``shard_column_batch`` have no counterpart:
a mesh is a list of ``torch.device`` here, and a part is moved where it
is scored.  ``partition_intervals`` is copied as it was.

The same device may appear twice in the list: its parts then run on two
streams of that device, which is how a one-card machine (and, with
``cpu``, a machine with none) exercises the split and the merge.
"""

from __future__ import annotations

import torch

from ..models.glfgen import ColumnBatch
from ..models.somatic import CallResult, call_batch
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
    return CallResult(*(None if fs[0] is None else torch.cat(fs)
                        for fs in zip(*parts)))


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
