"""Region-sharded streaming driver of the torch port.

The port's own copy of somatic_sniper_tpu/parallel/sharded.py: the
windows, the shard split, the contig-transition quirk carry and the
manifest are copied whole; the driver loop (:126-420 there) is ported,
because the source's imports its device pieces from the JAX runner.
Not copied: ``call_pair_sharded`` (a flattened record stream nothing in
the port uses).  Fast windows that can plan feed the port's
``TorchSlabDispatcher``; fast windows that cannot (no reference) go
through the batch path with a deferred one-window collect; exact
windows are scored by the native host layer.  This windowed driver
needs the native region loader, as the JAX one does.

The genome is cut into deterministic windows, each sought through the
BAI index: constant memory at whole-genome scale, shardable across
processes, and resumable per window.  The concatenation of all windows'
records (in window order) is byte-identical to the whole-file run.  The
one cross-window dependency is the reference's contig-transition drop
quirk (sniper_pileup.c:216): the first kept read of a contig is dropped
when its end precedes the previous contig's last kept-read start, which
a window at a contig start cannot see locally, so the driver carries
that value in via ``region_last_kept_start``.  Windows must be longer
than the longest read (columns of a quirk-dropped read must all fall in
the contig's first window).
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from pathlib import Path
from typing import Iterator

import numpy as np

from ..io import bai, native, native_api
from ..io.bam import BamHeader, read_bam_header
from ..io.fasta import FastaFile
from ..models.tables import ModelParams, build_tables, device_tables
from ..pileup.prefilter import prefilter_tables
from ..runner import (
    NOT_PORTED,
    RefCache,
    _make_ref16_fn,
    _prefilter_flags,
    _ref_blob,
    can_exact_native,
    can_plan,
    collect_pending,
    exact_records_native,
    make_plan,
    require_native,
    submit_batches,
)
from ..utils.stats import STATS
from .slab import TorchSlabDispatcher

DEFAULT_WINDOW = 250_000


def genome_windows(
    ref_lengths: list[int], window_size: int = DEFAULT_WINDOW
) -> list[tuple[int, int, int]]:
    """Deterministic (tid, beg, end) windows covering the genome."""
    out = []
    for tid, ln in enumerate(ref_lengths):
        beg = 0
        while beg < ln:
            out.append((tid, beg, min(beg + window_size, ln)))
            beg += window_size
    return out


def shard_windows(windows, shards: int, shard_index: int | None):
    """Contiguous split of the window list across shards (keeps each
    shard's output a contiguous genome span, so shard outputs
    concatenate in shard order)."""
    if shard_index is None:
        return list(windows)
    n = len(windows)
    lo = shard_index * n // shards
    hi = (shard_index + 1) * n // shards
    return list(windows[lo:hi])


class _QuirkCarry:
    """Per-file carried previous-contig last kept-read start values."""

    def __init__(self, bam_path: str, index: bai.BaiIndex, header: BamHeader,
                 flag_mask: int, mapq_thresh: int):
        self.path = bam_path
        self.index = index
        self.header = header
        self.flag_mask = flag_mask
        self.mapq_thresh = mapq_thresh

    def for_window(self, tid: int, beg: int) -> int:
        """drop_first_end_le for a window, or -1 when not applicable."""
        if beg != 0 or tid == 0:
            return -1
        lib = native.get_lib()
        # previous contig with any indexed reads
        for p in range(tid - 1, -1, -1):
            if self.index.refs[p].bins:
                break
        else:
            return -1
        plen = self.header.ref_lengths[p]
        # Backward scan in DISJOINT, escalating spans: each BGZF region
        # is decoded at most once (worst case = one pass over the
        # contig, vs the old overlapping escalation that re-decoded the
        # tail each round).  A span's result may be a read that merely
        # overlaps it (start < span begin), so a candidate is only final
        # once it is >= the current span's begin — an earlier span can
        # no longer hold a later start.
        best = -1
        hi = plen
        look = 1 << 15
        while hi > 0:
            beg_p = max(0, hi - look)
            chunks = bai.region_chunks(self.index, p, beg_p, hi)
            if chunks:
                ch = np.ascontiguousarray(
                    np.asarray(chunks, np.int64).reshape(-1, 2)
                )
                last = lib.region_last_kept_start(
                    self.path.encode(),
                    ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    len(ch), p, beg_p, hi,
                    self.flag_mask, self.mapq_thresh, 2,
                )
                if last > best:
                    best = int(last)
                if best >= beg_p:
                    return best
            hi = beg_p
            look *= 4
        return best


def call_pair_windows(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    fmt: str,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    window_size: int = DEFAULT_WINDOW,
    shards: int = 1,
    shard_index: int | None = None,
    skip_windows: set[int] | None = None,
    device=None,
) -> Iterator[tuple[int, tuple[int, int, int], list[str]]]:
    """Yield (window_index, window, output lines of ``fmt``) per genome
    window, in window order.  Window indices are global (stable across
    shard counts).  ``device`` scores the fast path's slabs."""
    require_native("the windowed driver (region loads)")
    if precision == "fast" and device is None:
        raise ValueError("fast precision needs a device")
    header = read_bam_header(tumor_bam)
    idx_t = bai.ensure_index(tumor_bam)
    idx_n = bai.ensure_index(normal_bam)
    windows = genome_windows(header.ref_lengths, window_size)
    mine = shard_windows(list(enumerate(windows)), shards, shard_index)

    fasta = FastaFile(ref_fasta) if ref_fasta else None
    refcache = RefCache(fasta, header)
    tabs = build_tables(params)
    ref_blob, ref_off = _ref_blob(fasta, header)
    packed16 = precision == "fast" and ref_blob is not None
    ref16_fn = _make_ref16_fn(ref_blob, ref_off) if packed16 else None

    carry_t = _QuirkCarry(tumor_bam, idx_t, header,
                          params.flag_mask, params.mapq_threshold)
    carry_n = _QuirkCarry(normal_bam, idx_n, header,
                          params.flag_mask, params.mapq_threshold)

    flag_args = None
    if ref_blob is not None:
        pt = prefilter_tables(tabs)
        if pt is not None:
            gmin, margin = pt
            flag_args = (ref_blob, ref_off, tabs.fk, gmin, margin)

    def _load_one(path, idx, carry, tid, beg, end):
        return native_api.load_region_and_columnize(
            path, np.asarray(bai.region_chunks(idx, tid, beg, end)),
            tid, beg, end, params.flag_mask, params.mapq_threshold,
            n_threads=1, drop_first_end_le=carry.for_window(tid, beg),
            flag_args=flag_args,
        )

    todo = [(wi, w) for wi, w in mine
            if not (skip_windows and wi in skip_windows)]
    # region-load pool: cores minus the main and device threads, in
    # [2, 6] (sharded.py:220-234)
    pool_n = max(2, min(6, (os.cpu_count() or 2) - 2))
    ex = ThreadPoolExecutor(max_workers=pool_n)
    # with threads to spare beyond a window's two loads, the window's
    # plan rides the pool too (sharded.py:239-247)
    offload_plan = pool_n >= 3

    def _submit_window(win):
        """The window's two region loads, and on wide pools its plan
        chained behind them; resolves to (pu_t, pu_n, plan-or-None)
        (sharded.py:249-299)."""
        tid, beg, end = win
        f_t = ex.submit(_load_one, tumor_bam, idx_t, carry_t, tid, beg, end)
        f_n = ex.submit(_load_one, normal_bam, idx_n, carry_n, tid, beg,
                        end)
        done = Future()
        n_landed = [0]
        cb_lock = threading.Lock()

        def _plan_task():
            try:
                pu_t, pu_n = f_t.result(), f_n.result()
                plan = None
                if can_exact_native(pu_t, pu_n, ref_blob):
                    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
                done.set_result((pu_t, pu_n, plan))
            except BaseException as e:  # surfaces on .result()
                done.set_exception(e)

        def _resolve_loads():
            try:
                done.set_result((f_t.result(), f_n.result(), None))
            except BaseException as e:
                done.set_exception(e)

        def _on_load(_):
            with cb_lock:
                n_landed[0] += 1
                if n_landed[0] < 2:
                    return
            if offload_plan:
                ex.submit(_plan_task)
            else:
                _resolve_loads()

        f_t.add_done_callback(_on_load)
        f_n.add_done_callback(_on_load)
        return done

    lookahead = 2 if pool_n <= 2 else (pool_n + 1) // 2 + 1
    inflight = [_submit_window(w) for _, w in todo[:lookahead]]

    slab_disp = None
    # the batch path's collect is deferred by one window, so its device
    # work runs under the next window's host work (sharded.py:326-335)
    deferred = None  # (wi, win, pu_t, pu_n, pending)

    def _collect(d):
        wi, win, pu_t, pu_n, pending = d
        records = collect_pending(pending, pu_t, pu_n, refcache,
                                  device_tables(tabs, device), device, fmt)
        return wi, win, [ln for _, ln in records]

    try:
        for i, (wi, (tid, beg, end)) in enumerate(todo):
            fut = inflight.pop(0)
            with STATS.timer("load_wait"):
                # drain landed slabs while the next loads run, so decode
                # and emit work fills what would be idle wait
                if slab_disp is not None:
                    while not fut.done():
                        slab_disp.poll()
                        yield from slab_disp.ready()
                        futures_wait([fut], timeout=0.02)
                pu_t, pu_n, plan = fut.result()
            j = i + lookahead
            if j < len(todo):
                inflight.append(_submit_window(todo[j][1]))
            win = (tid, beg, end)
            if precision == "exact":
                if not can_exact_native(pu_t, pu_n, ref_blob):
                    raise RuntimeError(
                        "exact precision needs native pileups and a "
                        "reference; the f64 glfgen fallback is "
                        + NOT_PORTED)
                lines = exact_records_native(
                    pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt,
                    plan=plan,
                )
                yield wi, win, [ln for _, ln in lines]
                continue
            if not can_plan(pu_t, pu_n, packed16):
                # batch path (sharded.py:381-408)
                drop_t, drop_n = _prefilter_flags(pu_t, pu_n, ref_blob,
                                                  ref_off, tabs)
                pending = submit_batches(
                    pu_t, pu_n, refcache, device_tables(tabs, device),
                    device, drop_t, drop_n, packed16, ref16_fn,
                    params.cap_mapq)
                if slab_disp is not None:  # mode-mix ordering guard
                    yield from slab_disp.finish()
                    slab_disp = None
                if deferred is not None:
                    yield _collect(deferred)
                deferred = (wi, win, pu_t, pu_n, pending)
                continue
            if deferred is not None:  # mode-mix ordering guard
                yield _collect(deferred)
                deferred = None
            if slab_disp is None:
                slab_disp = TorchSlabDispatcher(
                    lambda: device_tables(tabs, device), tabs, params,
                    refcache, device, fmt,
                )
            if plan is None:
                plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
            slab_disp.add_window(wi, win, pu_t, pu_n, plan,
                                 remaining=len(todo) - 1 - i)
            yield from slab_disp.ready()
        if slab_disp is not None:
            with STATS.timer("tail"):
                yield from slab_disp.finish()
        if deferred is not None:
            yield _collect(deferred)
    finally:
        ex.shutdown(wait=True)


def call_pair_sharded(*args, **kwargs) -> Iterator[str]:
    """Flattened line stream over :func:`call_pair_windows`."""
    for _, _, lines in call_pair_windows(*args, **kwargs):
        yield from lines


class Manifest:
    """Append-only per-window completion log for resumable runs.

    Each line: {"window": i, "offset": byte offset of the output file
    AFTER the window's records were flushed}.  On resume, the driver
    truncates the output to the last completed offset and skips the
    recorded windows — a crashed run loses at most one window.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.done: dict[int, int] = {}
        if self.path.exists():
            for ln in self.path.read_text().splitlines():
                try:
                    d = json.loads(ln)
                    self.done[int(d["window"])] = int(d["offset"])
                except (ValueError, KeyError):
                    continue

    def resume_offset(self) -> int | None:
        return max(self.done.values()) if self.done else None

    def mark(self, window: int, offset: int) -> None:
        self.done[window] = offset
        with open(self.path, "a") as fh:
            fh.write(json.dumps({"window": window, "offset": offset}) + "\n")
