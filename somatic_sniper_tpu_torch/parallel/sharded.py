"""Region-sharded streaming driver of the torch port.

The port's own copy of somatic_sniper_tpu/parallel/sharded.py: the
windows, the shard split, the contig-transition quirk carry and the
manifest are copied whole; the driver loop (:126-420 there) is ported,
because the source's imports its device pieces from the JAX runner.
Fast windows that can plan feed the port's ``TorchSlabDispatcher``;
windows that cannot (no reference) go through the batch path with a
deferred one-window collect, in either precision; exact windows with a
reference are scored by the native host layer, and a run made of such
windows alone resolves no device and imports no torch.  This windowed
path needs the native region loader, as the JAX one does.

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
import functools
import json
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from pathlib import Path
from typing import Iterator

import numpy as np

from ..device import resolve_device
from ..io import bai, native, native_api
from ..io.bam import BamHeader, read_bam_header
from ..io.fasta import FastaFile
from ..models.tables import ModelParams, build_tables, device_tables
from ..pileup.prefilter import prefilter_tables
from ..runner import (
    MAX_BATCH,
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
        # previous contig with any indexed reads
        for p in range(tid - 1, -1, -1):
            if self.index.refs[p].bins:
                break
        else:
            return -1
        with STATS.timer("load.carry"):
            return self._scan_back(p)

    def _scan_back(self, p: int) -> int:
        """The last kept-read start of contig ``p``."""
        lib = native.get_lib()
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


def _card_inflate_on(dev):
    """``dev``; a CUDA device also takes the region loads' BGZF blocks and
    their pileup builds (the kernels' ``sniper_card_inflate`` and
    ``sniper_card_pileup``, registered with the native loader)."""
    if dev.type == "cuda":
        from ..ops import build

        native.set_card_inflate(build.card_inflate_address(), dev.index)
        native.set_card_pileup(build.card_pileup_addresses())
    return dev


def call_pair_windows(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    fmt: str | None = None,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    window_size: int = DEFAULT_WINDOW,
    shards: int = 1,
    shard_index: int | None = None,
    skip_windows: set[int] | None = None,
    device=None,
    max_batch: int = MAX_BATCH,
    prefilter: bool = True,
) -> Iterator[tuple[int, tuple[int, int, int], list]]:
    """Yield (window_index, window, output lines of ``fmt``) per genome
    window, in window order; with ``fmt`` None the third item holds
    ``SniperRecord`` objects.  Window indices are global (stable across
    shard counts).  ``device`` (a ``torch.device`` or its name) scores
    the fast path's slabs, and the batches of windows that cannot plan;
    it is resolved when the first such window arrives (fast precision:
    at once), never by exact windows the native layer scores.
    ``prefilter=False`` scores every column the samples share, with the
    same output; ``max_batch`` bounds the batch path's batches."""
    with STATS.timer("driver.open"):
        require_native("the windowed driver (region loads)")
        if device is None and (precision == "fast" or not ref_fasta):
            raise ValueError(f"{precision} precision needs a device here")
        # the region loads inflate and build on the card once this call
        # has one
        native.set_card_inflate(None)
        native.set_card_pileup(None)
        dev = functools.cache(lambda: _card_inflate_on(resolve_device(device)))
        if precision == "fast":
            dev()  # a missing card fails the run before any load
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
        if prefilter and ref_blob is not None:
            pt = prefilter_tables(tabs)
            if pt is not None:
                gmin, margin = pt
                flag_args = (ref_blob, ref_off, tabs.fk, gmin, margin)

        todo = [(wi, w) for wi, w in mine
                if not (skip_windows and wi in skip_windows)]
        # SNIPER_LOAD_POOL bounds the concurrent region-load threads (the
        # native loader releases the GIL); --jobs sets it to 1 for its
        # workers when N workers x 2 load threads would oversubscribe the
        # host's cores.  Default: cores minus the main and device
        # threads, in [2, 6] (sharded.py:220-234)
        default_pool = max(2, min(6, (os.cpu_count() or 2) - 2))
        try:
            pool_n = max(1, int(
                os.environ.get("SNIPER_LOAD_POOL", str(default_pool))))
        except ValueError:
            pool_n = default_pool
        # windows in flight ahead of the one being scored;
        # SNIPER_LOOKAHEAD overrides, a bad value is ignored
        # (sharded.py:301-313)
        lookahead = 2 if pool_n <= 2 else (pool_n + 1) // 2 + 1
        try:
            lookahead = max(1, int(os.environ.get("SNIPER_LOOKAHEAD",
                                                  lookahead)))
        except ValueError:
            pass
        STATS.add("lookahead_windows", lookahead)
        ex = ThreadPoolExecutor(max_workers=pool_n)
        pool_t0 = time.perf_counter()
    # with threads to spare beyond a window's two loads, the window's
    # plan rides the pool too (sharded.py:239-247)
    offload_plan = pool_n >= 3

    def _pooled(fn, *args):
        """Submit ``fn(*args)`` to the pool, its wall time added to
        ``load_pool.busy``."""
        def task():
            t = time.perf_counter()
            try:
                return fn(*args)
            finally:
                STATS.record("load_pool.busy", time.perf_counter() - t)
        return ex.submit(task)

    def _load_one(wi, path, idx, carry, tid, beg, end):
        with STATS.context(window=wi), STATS.timer("load.region"):
            return native_api.load_region_and_columnize(
                path, np.asarray(bai.region_chunks(idx, tid, beg, end)),
                tid, beg, end, params.flag_mask, params.mapq_threshold,
                n_threads=1, drop_first_end_le=carry.for_window(tid, beg),
                flag_args=flag_args,
            )

    def _submit_window(wi, win):
        """The window's two region loads, and on wide pools its plan
        chained behind them; resolves to (pu_t, pu_n, plan-or-None)
        (sharded.py:249-299)."""
        tid, beg, end = win
        f_t = _pooled(_load_one, wi, tumor_bam, idx_t, carry_t, tid, beg,
                      end)
        f_n = _pooled(_load_one, wi, normal_bam, idx_n, carry_n, tid, beg,
                      end)
        done = Future()
        n_landed = [0]
        cb_lock = threading.Lock()
        # the loads' callbacks refer back to the loads: taken out once read,
        # so that a window's pileups go with its last reference rather than
        # wait for the cyclic collector
        loads = [f_t, f_n]

        def _results():
            try:
                return loads[0].result(), loads[1].result()
            finally:
                loads.clear()

        def _plan_task():
            try:
                pu_t, pu_n = _results()
                plan = None
                if can_exact_native(pu_t, pu_n, ref_blob):
                    with STATS.context(window=wi):
                        plan = make_plan(pu_t, pu_n, tabs, ref_blob,
                                         ref_off, prefilter,
                                         cns_mode="proof")
                done.set_result((pu_t, pu_n, plan))
            except BaseException as e:  # surfaces on .result()
                done.set_exception(e)

        def _resolve_loads():
            try:
                done.set_result((*_results(), None))
            except BaseException as e:
                done.set_exception(e)

        def _on_load(_):
            with cb_lock:
                n_landed[0] += 1
                if n_landed[0] < 2:
                    return
            if offload_plan:
                _pooled(_plan_task)
            else:
                _resolve_loads()

        f_t.add_done_callback(_on_load)
        f_n.add_done_callback(_on_load)
        return done

    inflight = [_submit_window(wi, w) for wi, w in todo[:lookahead]]

    slab_disp = None
    # the batch path's collect is deferred by one window, so its device
    # work runs under the next window's host work (sharded.py:326-335)
    deferred = None  # (wi, win, pu_t, pu_n, pending)

    def _collect(d):
        wi, win, pu_t, pu_n, pending = d
        records = collect_pending(pending, pu_t, pu_n, refcache,
                                  device_tables(tabs, dev(), precision),
                                  dev(), fmt, precision=precision)
        return wi, win, [rec for _, rec in records]

    try:
        for i, (wi, (tid, beg, end)) in enumerate(todo):
            fut = inflight.pop(0)
            # load_wait spans the loop's top: the polls, the emits of
            # earlier windows and the caller's time at those yields;
            # load_wait.block is the time blocked on the window's loads
            with STATS.context(window=wi), STATS.timer("load_wait"):
                # drain landed slabs while the next loads run, so decode
                # and emit work fills what would be idle wait
                if slab_disp is not None:
                    while not fut.done():
                        slab_disp.poll()
                        yield from slab_disp.ready()
                        with STATS.timer("load_wait.block"):
                            futures_wait([fut], timeout=0.02)
                if not fut.done():
                    with STATS.timer("load_wait.block"):
                        futures_wait([fut])
                pu_t, pu_n, plan = fut.result()
            j = i + lookahead
            if j < len(todo):
                inflight.append(_submit_window(*todo[j]))
            win = (tid, beg, end)
            if precision == "exact" and can_exact_native(pu_t, pu_n,
                                                         ref_blob):
                records = exact_records_native(
                    pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt,
                    plan=plan, prefilter=prefilter,
                )
                yield wi, win, [rec for _, rec in records]
                continue
            if not can_plan(pu_t, pu_n, packed16):
                # batch path (sharded.py:381-408)
                drop_t = drop_n = None
                if prefilter:
                    drop_t, drop_n = _prefilter_flags(pu_t, pu_n, ref_blob,
                                                      ref_off, tabs)
                pending = submit_batches(
                    pu_t, pu_n, refcache,
                    device_tables(tabs, dev(), precision), dev(), drop_t,
                    drop_n, packed16, ref16_fn, params.cap_mapq,
                    max_batch=max_batch, precision=precision)
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
                from .slab import TorchSlabDispatcher

                slab_disp = TorchSlabDispatcher(
                    lambda: device_tables(tabs, dev()), tabs, params,
                    refcache, dev(), fmt,
                )
            if plan is None:
                with STATS.context(window=wi):
                    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off,
                                     prefilter, cns_mode="proof")
            slab_disp.add_window(wi, win, pu_t, pu_n, plan)
            yield from slab_disp.ready()
        if slab_disp is not None:
            with STATS.timer("tail"):
                yield from slab_disp.finish()
        if deferred is not None:
            yield _collect(deferred)
    finally:
        ex.shutdown(wait=True)
        STATS.record("load_pool.open", pool_n * (time.perf_counter()
                                                  - pool_t0), threads=True)


def call_pair_sharded(*args, **kwargs) -> Iterator:
    """Flattened line (or record) stream over
    :func:`call_pair_windows`."""
    for _, _, recs in call_pair_windows(*args, **kwargs):
        yield from recs


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
