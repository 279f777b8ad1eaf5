"""Uniform-slab dispatch onto a torch device: one slab shape for a run.

The port's own copy of somatic_sniper_tpu/parallel/slab.py (depth
choice, cross-window filling, host scoring of deep columns, in-order
window release), one class, with the device interaction written for
torch: each full slab is uploaded on a dedicated CUDA stream, scored by
``models.somatic.call_batch_packed``, and its i32 rows come back after
one ``stream.synchronize()``.  Not copied: the source's
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
from ..models.somatic import COMPACT_FIELDS, MAX_D, call_batch_packed
from ..output.dqstats import get_dqstats_rows
from ..utils.stats import STATS

# Allowed slab depths: a coarse ladder so that nearby datasets (two
# pairs at 30x, say) land on the SAME shape.  48 exists because ~30x
# data (the dominant production coverage) has a dmax p99.5 of ~45-47:
# the 32->64 jump overshot pad/upload/kernel volume by a third.
ALLOWED_D = (16, 32, 48, 64, 128)
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
        np.minimum(np.asarray(dmax, np.int64), 256), minlength=257
    )
    return choose_d_hist(hist)


def choose_d_hist(hist: np.ndarray) -> int | None:
    """choose_d over an accumulated depth histogram (values clipped to
    256); same quantile semantics as np.quantile(..., method="lower")."""
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
    # pileup indices kept so the FINAL partial slab can be scored
    # host-side instead of dispatched (see finish): two int64 views,
    # ~16 B/column, held only while the segment is in the open slab
    ti: np.ndarray
    ni: np.ndarray


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
    out as (window index, window, output lines of ``fmt``).
    """

    def __init__(self, dtabs_fn, tabs, params, refcache, device, fmt: str,
                 max_live_windows: int = 8):
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
        self.queue: deque = deque()  # (segs, Future[(count, rows)]) FIFO
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
        self.fill = 0
        self.segs: list[_Seg] = []
        self.stacked_h = None
        self.meta_h = None
        # D selection state: windows stage (with an ``outstanding`` hold)
        # until enough depth evidence accumulates, then D is pinned from
        # the histogram; one later upgrade is allowed when the host-deep
        # fraction shows the pick was unrepresentative
        self._staged: list = []        # (ws, plan) awaiting D
        self._dhist = np.zeros(257, np.int64)
        self._total_cols = 0
        self._deep_cols = 0
        self._windows_seen = 0
        self._plan_cols = 0
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

    def add_window(self, wi, win, pu_t, pu_n, plan,
                   remaining: int | None = None) -> None:
        """Assign every plan column of a window: shallow ones into slabs,
        deep ones to the host-side exact scorer.

        ``remaining`` (windows still to come, when the driver knows it)
        enables the END-GAME cutover: once the projected rest of the run
        fits in the open slab AND sits under the device threshold,
        every further column is scored host-side immediately.  Those
        columns would have become the finish-time host tail anyway —
        scoring them as they arrive overlaps the work with the remaining
        loads, and it guarantees no slab is still in flight when the
        last load lands (the fast path's residual end-of-run stall)."""
        ws = _WindowState(wi, win, pu_t, pu_n)
        self.order.append(ws)
        n = len(plan.keys)
        if n:
            dmax = np.maximum(plan.d_t, plan.d_n)
            self._dhist += np.bincount(
                np.minimum(dmax.astype(np.int64), 256), minlength=257
            )
            self._windows_seen += 1
            self._plan_cols += n
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
            elif self._endgame(n, remaining):
                sel = np.arange(n, dtype=np.int64)
                self._host_cols(ws, plan, sel, "host_tail")
            else:
                self._assign(ws, plan)
        if self.fill and len(self.order) >= self.max_live:
            # bound held-window memory on sparse data (WGS hom-ref seas
            # could otherwise pin hundreds of windows under one slab)
            self._flush()
        self._pump()

    def _endgame(self, n: int, remaining: int | None) -> bool:
        """True when the projected rest of the run would end up as the
        finish-time host tail anyway (fits in the open slab, below the
        device threshold) — score it host-side NOW instead, under the
        remaining loads."""
        if remaining is None or self._windows_seen < 4:
            return False
        mean = (self._plan_cols - n) / max(self._windows_seen - 1, 1)
        projected = self.fill + n + remaining * mean
        return projected < min(self.B, self._tail_break_even(self.B))

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
                "scored host-side", file=sys.stderr, flush=True,
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
        with STATS.timer("pad+dispatch"):
            b = len(sel)
            s, e = self.fill, self.fill + b
            ref16 = np.ascontiguousarray(plan.ref16[sel])
            ti = np.ascontiguousarray(plan.ti[sel])
            ni = np.ascontiguousarray(plan.ni[sel])
            # one fused native call pads BOTH samples and assembles the
            # bit-packed metadata (models.somatic.call_batch_packed
            # layout: rms_sum < 255*cap^2 < 2^24 for D <= 255, ref16 on
            # bits 24-27 of row 0), internally threaded
            slab_fill_pair(
                ws.pu_t, ws.pu_n, ti, ni, ref16,
                plan.d_t[sel], plan.d_n[sel], self.D,
                self.params.cap_mapq,
                self.stacked_h[0, s:e], self.stacked_h[1, s:e],
                self.meta_h[0, s:e], self.meta_h[1, s:e],
                self.meta_h[2, s:e],
            )
            self.segs.append(
                _Seg(ws, np.ascontiguousarray(plan.keys[sel]), ref16,
                     s, e, ti, ni)
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

    def _host_cols(self, ws, plan, sel, stat: str) -> None:
        """Exact host scoring of a plan subset (deep columns, the
        end-game, or the finish tail); results stage like any device
        batch.  Exact output satisfies the fast contract by
        construction — same calls, zero phred drift."""
        with STATS.timer(stat):
            sel = np.ascontiguousarray(sel)
            p = self.params
            rows = exact_pair_rows(
                ws.pu_t, ws.pu_n, plan.ti[sel], plan.ni[sel],
                plan.ref16[sel], self.tabs, p.use_joint_priors,
                p.min_somatic_qual, p.include_loh, p.include_gor,
            )
            STATS.add(stat + "_columns", len(sel))
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

    def _host_deep(self, ws, plan, deep_idx) -> None:
        """Deep columns: native exact scoring, no device involvement
        (the run keeps one slab shape)."""
        self._host_cols(ws, plan, deep_idx, "host_deep")

    # -- dispatch / collect ----------------------------------------------

    def _tail_break_even(self, count: int) -> int:
        """Column count below which ``count`` tail columns host-score:
        the fixed threshold runner.device_min_cols (0 by default, so
        the run's end is dispatched like any other slab)."""
        from ..runner import device_min_cols

        return max(0, device_min_cols())

    def _flush(self) -> None:
        if self.fill == 0:
            return
        # The whole device interaction (upload, launches, fetch) runs
        # on the single background device thread: the main thread's
        # plan/pad/emit work is the pipeline's critical path.  One
        # thread keeps dispatch+fetch FIFO, so output order (and bytes)
        # cannot change.
        fut = self._collector.submit(
            self._dispatch_and_fetch, self.stacked_h, self.meta_h
        )
        self.queue.append((self.segs, fut))
        STATS.add("slabs_dispatched", 1)
        STATS.add("device_columns", self.fill)
        STATS.add(
            "device_upload_bytes",
            self.stacked_h.nbytes + self.meta_h.nbytes,
        )
        self._alloc()

    def _dispatch_and_fetch(self, stacked_h, meta_h):
        """Upload one slab, score it, return ``(count, rows[:count])``
        as numpy (runs on the background device thread; the host
        buffers are owned by the caller and never reused, _flush
        allocates fresh ones)."""
        dtabs = self.dtabs_fn()
        STATS.add(f"slabs_at_depth_{stacked_h.shape[2]}", 1)
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            if self._stream is not None:
                # the tables were uploaded on the default stream
                self._stream.wait_stream(
                    torch.cuda.default_stream(self.device))
            with STATS.timer("pad+dispatch.upload"):
                stacked = torch.from_numpy(stacked_h.view(np.int32)).to(
                    self.device)
                meta = torch.from_numpy(meta_h).to(self.device)
            res = call_batch_packed(stacked, meta, dtabs, self.params)
            count = res.count.to("cpu")
            rows = res.rows.to("cpu")
            if self._stream is not None:
                self._stream.synchronize()
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
        segs, fut = self.queue.popleft()
        with STATS.timer("device"):
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
        with STATS.timer("emit"):
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

    def _host_tail(self) -> None:
        """Score the open (final, partial) slab host-side via the exact
        native scorer instead of dispatching it.

        The final slab's dispatch->fetch round trip is the run's ONLY
        unhidden device latency — every mid-run dispatch rides under
        later plan/fill/emit work, but nothing follows the last one.
        Below the device threshold (runner.device_min_cols, which also
        gates small whole-file runs; 0 unless set) the tail is scored
        on the host.  Exact values satisfy the fast-mode
        output contract by construction — same calls, zero phred drift
        (tests pin byte-level window invariance either way)."""
        segs, self.segs = self.segs, []
        self.fill = 0
        p = self.params
        with STATS.timer("host_tail"):
            for seg in segs:
                rows = exact_pair_rows(
                    seg.ws.pu_t, seg.ws.pu_n, seg.ti, seg.ni, seg.ref16,
                    self.tabs, p.use_joint_priors, p.min_somatic_qual,
                    p.include_loh, p.include_gor,
                )
                STATS.add("host_tail_columns", len(seg.ti))
                if len(rows):
                    rows = self._widen_with_dq(
                        seg.ws.pu_t, seg.ws.pu_n, seg.ti, seg.ni,
                        seg.ref16, rows,
                    )
                with self._lock:
                    if len(rows):
                        seg.ws.pending.append((
                            seg.keys, seg.ref16.astype(np.int64), rows
                        ))
                    seg.ws.outstanding -= 1

    def finish(self):
        """Flush + collect everything; yield all remaining windows.

        Windows are emitted as soon as their last slab lands (the
        ``yield from self.ready()`` inside the loop): the held-back
        landed slab's decode + merged emit runs UNDER the final partial
        slab's dispatch->fetch round trip instead of after it.  A
        partial final slab below the device threshold skips the device
        entirely (see _host_tail)."""
        if self._staged:
            self._drain_staged()  # short runs: pin D from what we have
        if 0 < self.fill < self._tail_break_even(self.fill):
            self._host_tail()
        self._flush()
        while self.queue:
            self._collect_one()
            yield from self.ready()
        self._collector.shutdown(wait=True)
        yield from self.ready()
        assert not self.order, "slab dispatcher left incomplete windows"
