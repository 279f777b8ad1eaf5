"""Uniform-slab dispatch onto a torch device: one slab shape for a run.

The port's own copy of somatic_sniper_tpu/parallel/slab.py (depth
choice, cross-window filling, host scoring of deep columns, in-order
window release), one class, with the device interaction written for
torch: each full slab is uploaded on a dedicated CUDA stream, scored by
one replay of ``models.somatic.call_batch_packed`` captured as a CUDA
graph (``models.step_graph``; the counterpart of the source's jitted
step), and its i32 rows come back after one ``stream.synchronize()``.
On the CPU the eager step scores the slab.  A process scores on its one
device; several GPUs are reached through several processes
(``--shards`` / ``--jobs``, see ``runner``).
Not copied: the source's
``_dispatch_and_fetch`` (it imports JAX) and its u8 row decode; the
port's rows carry the slab index whole.

The whole run uses one slab shape:

* a canonical slab ``(2, B, D) u32`` + ``(3, B) int32`` metadata, with
  ``B`` fixed (default 8192) and ``D`` chosen once per run from the
  first planned windows' survivor-depth distribution;
* slabs are filled with plan-survivor columns ACROSS window boundaries
  and always dispatched full-size, so every slab of a run launches the
  kernels at one (B, D);
* columns deeper than ``D`` (rare: beyond p99.5 at normal coverage) are
  scored HOST-SIDE by the native exact scorer (io.native_api
  .exact_pair_rows).  Exact values trivially satisfy the fast-mode
  output contract (same calls, phred within the f32 quantization), and
  this removes every deep/oversize device shape from the run;
* results are fetched as a count and the rows buffer.

Collect is deferred (slabs in flight are scored while the host
plans/pads the next windows), and windows are yielded in order as soon
as every slab they contributed to has been collected.

The reference has no analog of any of this (single-threaded callback
loop, reference sniper_pileup.c:226-266); the contract it inherits is
output equality: record content is independent of slab packing, so
window/shard/slab boundaries never change output bytes.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ..io.native_api import exact_pair_rows, slab_fill_pair
from ..models.somatic import (COMPACT_FIELDS, MAX_D, MAX_D_NARROW,
                              call_batch_packed)
from ..models.step_graph import STEP_GRAPHS
from ..output.dqstats import get_dqstats_rows
from ..utils.stats import STATS

# Allowed slab depths: a coarse ladder so that nearby datasets (two
# pairs at 30x, say) land on the SAME shape.  48 exists because ~30x
# data (the dominant production coverage) has a dmax p99.5 of ~45-47:
# the 32->64 jump overshot pad/upload/kernel volume by a third.  255 is
# the deepest slab of the byte-wide metadata and the fused glfgen32;
# the tiers above it (deep capture panels: a 300x pair's dmax p99.5 is
# ~350, a 700x tumor's ~770) take the wide metadata and the c_tot > 255
# rescale on the card (models/somatic.py packed_column_batches,
# models/glfgen.py).
ALLOWED_D = (16, 32, 48, 64, 128, 255, 384, 512, 768, 1024)
# the depth histogram's last bin counts every column deeper than the
# deepest tier
HIST_TOP = ALLOWED_D[-1] + 1
# A slab spanning many windows lands its results in a burst, the burst's
# emit work stalls the bounded load prefetch, and the loaders idle: wall
# follows the landing CADENCE, not the dispatch count.  8192 is about
# 2.5 windows' survivors at 30x and 250 kb windows.
DEFAULT_B = 8192
# fraction of survivor columns the slab depth must cover; the remainder
# is scored host-side (exact), so this trades upload padding against
# host math on the tail
COVER_TARGET = 0.995
# most columns a slab may hold (SNIPER_SLAB_B is clamped to it); the
# depth bound MAX_D is the packed metadata's (models.somatic)
MAX_B = 65536


def slab_b() -> int:
    try:
        b = int(os.environ.get("SNIPER_SLAB_B", DEFAULT_B))
    except ValueError:
        return DEFAULT_B
    return min(max(b, 1), MAX_B)


# D is pinned only after this much evidence (whichever comes first):
# pinning D from the FIRST non-empty window would let a shallow
# telomere window lock a small D and send every deeper column of the
# run to the host-side exact scorer
D_SAMPLE_WINDOWS = 4
D_SAMPLE_COLS = 16384
# host-deep fraction that (a) triggers the one allowed mid-run depth
# upgrade and (b) warns on stderr — above it, fast mode is quietly
# degrading into mostly-host scoring
DEEP_WARN_FRAC = 0.05


def choose_d(dmax: np.ndarray) -> int | None:
    """Smallest allowed depth covering COVER_TARGET of the columns."""
    if len(dmax) == 0:
        return None
    hist = np.bincount(
        np.minimum(np.asarray(dmax, np.int64), HIST_TOP),
        minlength=HIST_TOP + 1,
    )
    return choose_d_hist(hist)


def choose_d_hist(hist: np.ndarray) -> int | None:
    """choose_d over an accumulated depth histogram (values clipped to
    HIST_TOP); same quantile semantics as np.quantile(...,
    method="lower")."""
    n = int(hist.sum())
    if n == 0:
        return None
    override = os.environ.get("SNIPER_SLAB_D")
    if override:
        try:
            return min(max(int(override), 1), MAX_D)
        except ValueError:
            pass
    idx = int(COVER_TARGET * (n - 1))
    q = int(np.searchsorted(np.cumsum(hist), idx + 1))
    for d in ALLOWED_D:
        if q <= d:
            return d
    return ALLOWED_D[-1]


class _Seg(NamedTuple):
    """One window's contiguous span of rows inside a slab."""

    ws: "_WindowState"
    keys: np.ndarray    # int64 [n] column keys
    ref16: np.ndarray   # int32 [n]
    start: int          # row range [start, end) inside the slab
    end: int


class _WindowState:
    __slots__ = ("wi", "win", "pu_t", "pu_n", "outstanding", "records",
                 "pending")

    def __init__(self, wi, win, pu_t, pu_n):
        self.wi = wi
        self.win = win
        self.pu_t = pu_t
        self.pu_n = pu_n
        self.outstanding = 0          # slabs (incl. the open one) pending
        self.records: list = []       # (key, record) accumulated
        # (keys, ref16, rows) result batches staged for one merged
        # emit at yield time: a window's rows arrive as per-slab
        # segments plus a host-deep batch, and each emit call pays a
        # fixed ctypes/array-setup cost that dwarfs the per-row work
        # for the typical few-thousand-row (or few-row deep) batch
        self.pending: list = []
        # ``outstanding`` is mutated from the main thread (+1 per slab
        # contribution) and the collector thread (-1 per collected
        # slab); TorchSlabDispatcher._lock guards every mutation/read.


class TorchSlabDispatcher:
    """Cross-window uniform-slab dispatcher for the fast device path,
    its slabs scored on ``device``.

    ``dtabs_fn`` is a zero-arg callable returning the port's
    DeviceTables for ``device`` (lazy so a run that never dispatches,
    all windows empty, never uploads the coef table).  ``tabs`` are the
    host f64 tables for the deep-column host-side scorer.  Windows come
    out as (window index, window, output lines of ``fmt``), or, with
    ``fmt`` None, as ``SniperRecord`` objects: every row of a window,
    from the card or from the host's deep scoring, carries its
    36 dqstats columns, which the record builder turns into ``DqStats``.
    """

    def __init__(self, dtabs_fn, tabs, params, refcache, device,
                 fmt: str | None = None, max_live_windows: int = 8):
        self.dtabs_fn = dtabs_fn
        self.tabs = tabs
        self.params = params
        self.refcache = refcache
        self.fmt = fmt
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.B = slab_b()
        self.D: int | None = None
        self.max_live = max_live_windows
        self.order: deque[_WindowState] = deque()
        # (segs, Future[(count, rows)], slab index) FIFO
        self.queue: deque = deque()
        self.slabs_flushed = 0
        # One background device thread owns the whole device
        # interaction per slab (upload, launches, result fetch, see
        # _dispatch_and_fetch), so the wait for the card rides under the
        # main thread's plan/fill/emit of later windows.  Record
        # building stays on the main thread, which keeps the "device"
        # timer an honest blocked-on-device measure.
        self._collector = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="slab-collect"
        )
        self._lock = threading.Lock()
        self._in_flight = threading.Lock()
        self.fill = 0
        self.segs: list[_Seg] = []
        self.stacked_h = None
        self.meta_h = None
        # D selection state: windows stage (with an ``outstanding`` hold)
        # until enough depth evidence accumulates, then D is pinned from
        # the histogram; one later upgrade is allowed when the host-deep
        # fraction shows the pick was unrepresentative
        self._staged: list = []        # (ws, plan) awaiting D
        self._dhist = np.zeros(HIST_TOP + 1, np.int64)
        self._total_cols = 0
        self._deep_cols = 0
        self._upgraded = False
        self._warned_deep = False

    # -- filling ---------------------------------------------------------

    def _alloc(self):
        # u32 raw kept-only lanes: the fill is a filtered copy
        # of pileup slot words, and the device derives eff/classes/rms
        # and the dqstats fields itself (models/somatic.py raw32)
        self.stacked_h = np.zeros((2, self.B, self.D), np.uint32)
        self.meta_h = np.zeros((3, self.B), np.int32)
        self.fill = 0
        self.segs = []

    def add_window(self, wi, win, pu_t, pu_n, plan) -> None:
        """Assign every plan column of a window: shallow ones into slabs,
        deep ones to the host-side exact scorer."""
        ws = _WindowState(wi, win, pu_t, pu_n)
        self.order.append(ws)
        n = len(plan.keys)
        if n:
            dmax = np.maximum(plan.d_t, plan.d_n)
            self._dhist += np.bincount(
                np.minimum(dmax.astype(np.int64), HIST_TOP),
                minlength=HIST_TOP + 1,
            )
            if self.D is None:
                # stage until enough depth evidence: the hold keeps
                # ready() from yielding the window before assignment
                with self._lock:
                    ws.outstanding += 1
                self._staged.append((ws, plan))
                if (
                    self._dhist.sum() >= D_SAMPLE_COLS
                    or len(self._staged) >= D_SAMPLE_WINDOWS
                ):
                    self._drain_staged()
            else:
                self._assign(ws, plan)
        if self.fill and len(self.order) >= self.max_live:
            # bound held-window memory on sparse data (WGS hom-ref seas
            # could otherwise pin hundreds of windows under one slab)
            self._flush()
        self._pump()

    def _drain_staged(self) -> None:
        """Pin D from the accumulated histogram; assign staged windows."""
        self.D = choose_d_hist(self._dhist)
        staged, self._staged = self._staged, []
        for ws, plan in staged:
            self._assign(ws, plan)
            with self._lock:
                ws.outstanding -= 1

    def _assign(self, ws, plan) -> None:
        n = len(plan.keys)
        dmax = np.maximum(plan.d_t, plan.d_n)
        deep = np.nonzero(dmax > self.D)[0]
        self._total_cols += n
        self._deep_cols += len(deep)
        if len(deep) and self._maybe_upgrade_d():
            old = len(deep)
            deep = np.nonzero(dmax > self.D)[0]
            self._deep_cols -= old - len(deep)
        shallow = np.nonzero(dmax <= self.D)[0] if len(deep) else None
        if len(deep):
            self._host_deep(ws, plan, deep)
        if self.stacked_h is None:
            self._alloc()
        pos, total = 0, (n - len(deep))
        sh = shallow  # None means "all of plan"
        while pos < total:
            take = min(self.B - self.fill, total - pos)
            sel = (
                np.arange(pos, pos + take, dtype=np.int64)
                if sh is None else np.ascontiguousarray(
                    sh[pos:pos + take]
                )
            )
            self._write_part(ws, plan, sel)
            pos += take
            if self.fill == self.B:
                self._flush()

    def _maybe_upgrade_d(self) -> bool:
        """One mid-run depth upgrade when the pinned D proves too small.

        A shallow early sample (low-coverage telomere windows) would
        otherwise silently route every deeper column of the run to the
        host-side exact scorer.  The upgrade costs one extra slab shape,
        taken only when >DEEP_WARN_FRAC of a meaningful sample is
        already being scored host-side.  Never fires
        under an explicit SNIPER_SLAB_D override."""
        if self._total_cols < D_SAMPLE_COLS:
            return False
        frac = self._deep_cols / self._total_cols
        if frac <= DEEP_WARN_FRAC:
            return False
        if not self._warned_deep:
            self._warned_deep = True
            print(
                f"somatic_sniper_tpu_torch: {100 * frac:.1f}% of survivor "
                f"columns exceed the slab depth D={self.D} and are "
                f"scored host-side (the deepest slab tier is "
                f"{ALLOWED_D[-1]})", file=sys.stderr, flush=True,
            )
        if (
            self._upgraded
            or os.environ.get("SNIPER_SLAB_D")
            or self.D >= ALLOWED_D[-1]
        ):
            return False
        new_d = choose_d_hist(self._dhist)
        if not new_d or new_d <= self.D:
            return False
        self._flush()  # the open slab still uses the old shape
        print(
            f"somatic_sniper_tpu_torch: upgrading slab depth {self.D} -> "
            f"{new_d} (one-time)", file=sys.stderr, flush=True,
        )
        self.D = new_d
        self._upgraded = True
        if self.stacked_h is not None:
            self._alloc()  # reallocate the open slab at the new depth
        return True

    def _write_part(self, ws, plan, sel) -> None:
        with STATS.context(window=ws.wi), STATS.timer("pad+dispatch"):
            b = len(sel)
            s, e = self.fill, self.fill + b
            ref16 = np.ascontiguousarray(plan.ref16[sel])
            ti = np.ascontiguousarray(plan.ti[sel])
            ni = np.ascontiguousarray(plan.ni[sel])
            # one fused native call pads BOTH samples and assembles the
            # bit-packed metadata (models.somatic.packed_column_batches:
            # depths and kept counts in bytes to D = 255, in 16-bit
            # halves deeper; ref16 on bits 24-27 of row 0), internally
            # threaded
            slab_fill_pair(
                ws.pu_t, ws.pu_n, ti, ni, ref16,
                plan.d_t[sel], plan.d_n[sel], self.D,
                self.params.cap_mapq,
                self.stacked_h[0, s:e], self.stacked_h[1, s:e],
                self.meta_h[0, s:e], self.meta_h[1, s:e],
                self.meta_h[2, s:e],
            )
            self.segs.append(
                _Seg(ws, np.ascontiguousarray(plan.keys[sel]), ref16, s, e)
            )
            with self._lock:
                ws.outstanding += 1
            self.fill = e

    def _widen_with_dq(self, pu_t, pu_n, ti, ni, ref16, rows):
        """Append the 36 host-computed dqstats columns to exact host
        rows (tumor 18 then normal 18, the device row layout) so merged
        windows concatenate uniformly with device rows, whose dqstats
        come back from the card."""
        idx = np.asarray(rows[:, 0], np.int64)
        rb4 = np.asarray(ref16, np.int64)[idx]
        teff = rows[:, 1 + COMPACT_FIELDS.index("tumor_eff_gt")]
        neff = rows[:, 1 + COMPACT_FIELDS.index("normal_eff_gt")]
        wanted = rb4 | teff | neff
        dq_t = get_dqstats_rows(pu_t, np.asarray(ti)[idx], rb4, wanted)
        dq_n = get_dqstats_rows(pu_n, np.asarray(ni)[idx], rb4, wanted)
        return np.concatenate(
            [rows, dq_t.astype(rows.dtype), dq_n.astype(rows.dtype)],
            axis=1,
        )

    def _host_deep(self, ws, plan, sel) -> None:
        """Deep columns: native exact scoring, no device involvement
        (the run keeps one slab shape); results stage like any device
        batch.  Exact output satisfies the fast contract by
        construction — same calls, zero phred drift."""
        with STATS.context(window=ws.wi), STATS.timer("host_deep"):
            sel = np.ascontiguousarray(sel)
            p = self.params
            rows = exact_pair_rows(
                ws.pu_t, ws.pu_n, plan.ti[sel], plan.ni[sel],
                plan.ref16[sel], self.tabs, p.use_joint_priors,
                p.min_somatic_qual, p.include_loh, p.include_gor,
            )
            STATS.add("host_deep_columns", len(sel))
            if len(rows):
                rows = self._widen_with_dq(
                    ws.pu_t, ws.pu_n, plan.ti[sel], plan.ni[sel],
                    plan.ref16[sel], rows,
                )
                with self._lock:
                    ws.pending.append((
                        np.asarray(plan.keys[sel], np.int64),
                        np.asarray(plan.ref16[sel], np.int64),
                        rows,
                    ))

    # -- dispatch / collect ----------------------------------------------

    def _flush(self) -> None:
        if self.fill == 0:
            return
        # The whole device interaction (upload, launches, fetch) runs
        # on the single background device thread: the main thread's
        # plan/pad/emit work is the pipeline's critical path.  One
        # thread keeps dispatch+fetch FIFO, so output order (and bytes)
        # cannot change.
        slab = self.slabs_flushed
        self.slabs_flushed += 1
        fut = self._collector.submit(
            self._dispatch_and_fetch, self.stacked_h, self.meta_h, slab
        )
        self.queue.append((self.segs, fut, slab))
        STATS.add("slabs_dispatched", 1)
        STATS.add("device_columns", self.fill)
        if self.D > MAX_D_NARROW:
            STATS.add("device_columns_deep", self.fill)
        # the lanes and metadata the slab's upload carries, padding
        # included
        STATS.add(
            "slab_bytes_uploaded",
            self.stacked_h.nbytes + self.meta_h.nbytes,
        )
        self._alloc()

    def _dispatch_and_fetch(self, stacked_h, meta_h, slab=None):
        """Upload one slab, score it, return ``(count, rows[:count])``
        as numpy (runs on the background device thread; the host
        buffers are owned by the caller and never reused, _flush
        allocates fresh ones).

        On a card the slab goes through the step's captured CUDA graph
        (models.step_graph), whose fixed buffers the next slab reuses:
        that holds because one slab is in flight at a time (the
        collector has one worker), which the ``_in_flight`` lock
        asserts.  Only the CPU scores eagerly; a failed capture or
        replay raises.  ``slab``: the slab's index, the id
        the device thread's spans carry."""
        if not self._in_flight.acquire(blocking=False):
            raise AssertionError("a second slab in flight")
        try:
            with STATS.context(slab=slab):
                return self._score_slab(stacked_h, meta_h)
        finally:
            self._in_flight.release()

    def _score_slab(self, stacked_h, meta_h):
        from ..runner import _raise_on_count_error

        dtabs = self.dtabs_fn()
        STATS.add(f"slabs_at_depth_{stacked_h.shape[2]}", 1)
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            if self._stream is not None:
                # the tables were uploaded on the default stream
                self._stream.wait_stream(
                    torch.cuda.default_stream(self.device))
            if STEP_GRAPHS.captures_on(self.device):
                # the captured step, and never the eager one
                STATS.add("slabs_graphed", 1)
                return STEP_GRAPHS.run(stacked_h, meta_h, dtabs,
                                       self.params, self.device)
            # the CPU: the eager step over the plain versions
            res = call_batch_packed(torch.from_numpy(
                stacked_h.view(np.int32)), torch.from_numpy(meta_h),
                dtabs, self.params)
            count = res.count.to("cpu")
            err = res.err.to("cpu")
            rows = res.rows.to("cpu")
            if self._stream is not None:
                self._stream.synchronize()
        # a deep slab's error word, read with its rows (the captured
        # step's fetch reads its own)
        _raise_on_count_error([int(err)], [stacked_h.shape[2]])
        n = int(count)
        return n, rows[:n].numpy()

    def poll(self) -> None:
        """Drain landed slabs opportunistically (same hold-one policy
        as the add_window pump).  The windowed driver calls this while
        BLOCKED on the next window's loads, so decode + emit work runs
        inside what used to be idle wait time."""
        self._pump()

    def _pump(self) -> None:
        # Drain landed slabs, but deliberately keep ONE done-but-
        # uncollected slab in the queue; never block mid-run.  Holding
        # the newest landed slab back means finish() always has ~a
        # slab's worth of decode+emit CPU work in hand to run UNDER the
        # final partial slab's dispatch->fetch round trip.  Collection
        # order stays FIFO, so output bytes are unchanged; the cost is
        # one held rows buffer.
        while (
            len(self.queue) >= 2 and self.queue[0][1].done()
        ):
            self._collect_one()

    def _collect_one(self) -> None:
        """Stage one fetched slab's rows per window segment (main
        thread; the fetch itself already happened on the collector
        thread).  The rows' first column is the slab index.  Record
        building is deferred to :meth:`ready` so each window pays ONE
        emit call over all its batches instead of one per slab segment
        plus one per host-deep tail."""
        segs, fut, slab = self.queue.popleft()
        with STATS.context(slab=slab), STATS.timer("device"):
            _, rows = fut.result()
        idx = rows[:, 0]
        for seg in segs:
            lo, hi = np.searchsorted(idx, [seg.start, seg.end])
            sub = None
            if hi > lo:
                sub = rows[lo:hi].astype(np.int64)
                sub[:, 0] -= seg.start
            with self._lock:
                if sub is not None:
                    seg.ws.pending.append(
                        (seg.keys, seg.ref16.astype(np.int64), sub))
                seg.ws.outstanding -= 1

    def _emit_window(self, ws) -> None:
        """One merged emit over every staged result batch of a window
        (its row indices are rebased onto the concatenated key list)."""
        from ..runner import emit_records_compact

        with self._lock:
            pending, ws.pending = ws.pending, []
        if not pending:
            return
        base = 0
        keys_l, ref_l, rows_l = [], [], []
        for keys, ref16, rows in pending:
            # pending batches are freshly owned (_collect_one /
            # _host_cols), so the index rebase mutates in place; i32
            # host rows widen here (np.asarray copies on dtype change
            # only)
            r = np.asarray(rows, np.int64)
            r[:, 0] += base
            rows_l.append(r)
            keys_l.append(keys)
            ref_l.append(ref16)
            base += len(keys)
        with STATS.context(window=ws.wi), STATS.timer("emit"):
            recs = emit_records_compact(
                np.concatenate(keys_l), np.concatenate(rows_l),
                np.concatenate(ref_l), ws.pu_t, ws.pu_n, self.refcache,
                self.fmt,
            )
        ws.records.extend(recs)

    # -- draining ----------------------------------------------------------

    def ready(self):
        """Yield (wi, win, records) for every completed prefix window."""
        while True:
            with self._lock:
                if not self.order or self.order[0].outstanding != 0:
                    return
                ws = self.order.popleft()
            self._emit_window(ws)
            ws.records.sort(key=lambda kv: kv[0])
            STATS.add("records_emitted", len(ws.records))
            yield ws.wi, ws.win, [r for _, r in ws.records]

    def finish(self):
        """Flush + collect everything; yield all remaining windows.

        Windows are emitted as soon as their last slab lands (the
        ``yield from self.ready()`` inside the loop): the held-back
        landed slab's decode + merged emit runs UNDER the final partial
        slab's dispatch->fetch round trip instead of after it.  The
        final slab is dispatched like any other, its padding empty."""
        if self._staged:
            self._drain_staged()  # short runs: pin D from what we have
        self._flush()
        while self.queue:
            self._collect_one()
            yield from self.ready()
        self._collector.shutdown(wait=True)
        yield from self.ready()
        assert not self.order, "slab dispatcher left incomplete windows"
