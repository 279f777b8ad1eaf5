"""Per-stage runtime counters (observability layer).

The reference has no tracing at all — four startup ``fprintf(stderr)``
lines (reference main.c:116-130) are its entire observability story.
This module gives the caller the per-stage wall-clock and volume
counters SURVEY.md §5 calls for: decode, plan, pad/upload, device
compute, emit — cheap enough to stay on in production (one perf_counter
pair per stage call).

Usage::

    from ..utils.stats import STATS
    with STATS.timer("decode"):
        ...
    STATS.add("columns", n)

Enable the stderr summary with ``--stats`` on the CLI (or
``SNIPER_STATS=1``); enable a torch.profiler trace with
``SNIPER_PROFILE=<dir>`` (a Chrome trace, view in Perfetto).

Copy of somatic_sniper_tpu/utils/stats.py: the port keeps its own host
layer and imports nothing of the JAX package.  ``maybe_profile`` is not
copied as it was (the source starts a JAX profiler trace): here it
records with ``torch.profiler`` and writes the span log into the same
trace.  The port's additions:

- ``record``: seconds measured elsewhere (a --jobs worker's start-up
  begins in its parent; a pool's busy and open time);
- ``context``: a thread's window (or slab) id, and the stage open on
  the thread, which each span records as its parent; never arguments of
  ``timer``, which takes the stage alone;
- ``add_source``: a reader of counters kept elsewhere (the native
  loader's phases), read without reset: ``reset`` takes a baseline and
  ``snapshot`` gives the deltas from it;
- the span log (``start_log`` / ``stop_log``): while ``maybe_profile``
  is open, every span as (stage, thread id, context, parent stage,
  start ns, end ns) on ``time.perf_counter_ns``, CLOCK_MONOTONIC, the
  clock of the native loader's ``steady_clock``;
- ``summary`` gives each stage's share of the run's wall, not of a sum
  of stages that nest and overlap across threads.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class RunStats:
    """Thread-safe wall-clock and volume counters keyed by stage name."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)
        self._local = threading.local()
        self._threads: set[str] = set()  # stages summed over threads
        self._sources: list = []
        self._base: dict = {}
        self._t0 = time.perf_counter_ns()
        self._log: list | None = None
        self._log_cap = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    @contextmanager
    def timer(self, stage: str):
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(stage)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            if stack[-1] == stage:
                stack.pop()
            else:  # a generator closed under a later span of its thread
                del stack[len(stack) - 1 - stack[::-1].index(stage)]
            off_main = threading.current_thread() is not threading.main_thread()
            with self._lock:
                self.seconds[stage] += (t1 - t0) * 1e-9
                self.calls[stage] += 1
                if off_main:
                    self._threads.add(stage)
                if self._log is not None:
                    self._log_span(stage, parent, t0, t1)

    def _log_span(self, stage, parent, t0, t1) -> None:
        if len(self._log) >= self._log_cap:
            self.counts["span_log_dropped"] += 1
            return
        loc = self._local
        try:
            tid = loc.tid
        except AttributeError:  # a system call: once a thread
            tid = loc.tid = threading.get_native_id()
        self._log.append((stage, tid, getattr(loc, "tag", None), parent,
                          t0, t1))

    @contextmanager
    def context(self, **tag):
        """The id the thread's spans carry while open: ``window=i`` (a
        genome window) or ``slab=i`` (a slab on the device thread)."""
        (item,) = tag.items()
        prev = getattr(self._local, "tag", None)
        self._local.tag = item
        try:
            yield
        finally:
            self._local.tag = prev

    def record(self, stage: str, seconds: float,
               threads: bool = False) -> None:
        """Add ``seconds`` measured elsewhere to a stage (not in the
        source: a --jobs worker's start-up begins in its parent);
        ``threads``: seconds summed over threads."""
        off_main = threading.current_thread() is not threading.main_thread()
        with self._lock:
            self.seconds[stage] += seconds
            self.calls[stage] += 1
            if threads or off_main:
                self._threads.add(stage)

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counts[counter] += n

    def add_source(self, read) -> None:
        """``read()`` gives ({stage: cumulative thread-seconds},
        {counter: cumulative count}) kept outside this object."""
        with self._lock:
            self._sources.append(read)

    def _read_sources(self) -> tuple[dict, dict]:
        with self._lock:
            sources = list(self._sources)
        secs, counts = {}, {}
        for read in sources:
            s, c = read()
            secs.update(s)
            counts.update(c)
        return secs, counts

    def _sourced(self) -> tuple[dict, dict]:
        """The sources' entries less the baseline of the last reset."""
        secs, counts = self._read_sources()
        base = self._base
        return ({k: v - base.get(k, 0) for k, v in secs.items()},
                {k: v - base.get(k, 0) for k, v in counts.items()})

    def reset(self) -> None:
        secs, counts = self._read_sources()
        with self._lock:
            self.seconds.clear()
            self.calls.clear()
            self.counts.clear()
            self._threads.clear()
            self._base = {**secs, **counts}
            self._t0 = time.perf_counter_ns()

    def snapshot(self) -> dict:
        """Point-in-time {stage: seconds} ∪ {counter: count} copy, for
        differential measurements (bench.py's device-phase split)."""
        secs, counts = self._sourced()
        with self._lock:
            out: dict = dict(self.seconds)
            out.update(self.counts)
        out.update(secs)
        out.update(counts)
        return out

    def summary(self) -> str:
        """Each stage's seconds, share of the run's wall (since this
        object was made or reset) and calls; ``thread-s`` marks a stage
        summed over threads other than the main one (pool, device
        thread, the native loader), whose share can pass 100%.  Stages
        nest (``load_wait`` holds ``load_wait.block``), so shares do
        not add up."""
        secs, counts = self._sourced()
        with self._lock:
            stages = dict(self.seconds)
            calls = dict(self.calls)
            threads = self._threads | set(secs)
            counts.update(self.counts)
            wall = (time.perf_counter_ns() - self._t0) * 1e-9
        stages.update(secs)
        lines = ["[sniper-tpu stats]"]
        if stages:
            lines[0] += f" wall {wall:.3f}s"
        for stage in sorted(stages, key=stages.get, reverse=True):
            s = stages[stage]
            pct = 100.0 * s / wall if wall else 0.0
            n = f"({calls[stage]} calls)" if stage in calls else ""
            kind = "  thread-s" if stage in threads else ""
            lines.append(
                f"  {stage:<22} {s:8.3f}s  {pct:6.1f}% of wall  {n}{kind}"
                .rstrip())
        for name in sorted(counts):
            lines.append(f"  {name:<22} {counts[name]}")
        return "\n".join(lines)

    def start_log(self, cap: int = 1 << 20) -> None:
        """Keep every span from now on, up to ``cap`` (the rest are
        counted as ``span_log_dropped``)."""
        with self._lock:
            self._log, self._log_cap = [], cap

    def stop_log(self) -> list:
        with self._lock:
            log, self._log = self._log or [], None
            return log


STATS = RunStats()

ALIGN_MARK = "sniper.align"


def enabled() -> bool:
    return os.environ.get("SNIPER_STATS", "") not in ("", "0")


@contextmanager
def maybe_profile():
    """torch.profiler trace over the wrapped region when SNIPER_PROFILE
    is set to a directory path: host activity, and the card's when one
    is present, written as ``<dir>/trace.json`` (Chrome trace), with
    ``STATS``'s span log in it as complete events on the trace's clock."""
    trace_dir = os.environ.get("SNIPER_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    with profile(activities=activities) as prof:
        # the first record_function pays its set-up (~0.3 ms on an H100
        # host) before it takes its time stamp: the second one aligns
        for _ in range(2):
            t_a = time.perf_counter_ns()
            with record_function(ALIGN_MARK):
                pass
            t_b = time.perf_counter_ns()
        STATS.start_log()
        try:
            yield
        finally:
            spans = STATS.stop_log()
    prof.export_chrome_trace(path)
    add_spans(path, spans, (t_a + t_b) // 2)


def add_spans(path: str, spans: list, t_align: int) -> None:
    """Write ``spans`` (``RunStats.stop_log``) into the Chrome trace at
    ``path`` as ``X`` events of the category ``sniper``, shifted onto
    the trace's timebase by the midpoint of its last ``ALIGN_MARK``
    event, which ``perf_counter_ns`` ``t_align`` brackets; ``sniperAlign``
    keeps the pair (trace us, ns)."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    mark = max((e for e in events if e.get("name") == ALIGN_MARK),
               key=lambda e: float(e["ts"]))
    at = float(mark["ts"]) + float(mark.get("dur", 0)) / 2
    off = at - t_align / 1e3
    for stage, tid, tag, parent, t0, t1 in spans:
        args = {"parent": parent}
        if tag is not None:
            args[tag[0]] = tag[1]
        events.append({"name": stage, "cat": "sniper", "ph": "X",
                       "pid": mark["pid"], "tid": tid,
                       "ts": t0 / 1e3 + off, "dur": (t1 - t0) / 1e3,
                       "args": args})
    trace["sniperAlign"] = {"perf_counter_ns": t_align, "ts": at}
    with open(path, "w") as fh:
        json.dump(trace, fh)
