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
layer and imports nothing of the JAX package.  ``maybe_profile`` is the
one function not copied as it was (the source starts a JAX profiler
trace): here it records with ``torch.profiler``.
"""

from __future__ import annotations

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

    @contextmanager
    def timer(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[stage] += dt
                self.calls[stage] += 1

    def add(self, counter: str, n: int = 1) -> None:
        with self._lock:
            self.counts[counter] += n

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()
            self.counts.clear()

    def snapshot(self) -> dict:
        """Point-in-time {stage: seconds} ∪ {counter: count} copy, for
        differential measurements (bench.py's device-phase split)."""
        with self._lock:
            out: dict = dict(self.seconds)
            out.update(self.counts)
            return out

    def summary(self) -> str:
        lines = ["[sniper-tpu stats]"]
        total = sum(self.seconds.values())
        for stage in sorted(self.seconds, key=self.seconds.get,
                            reverse=True):
            s = self.seconds[stage]
            pct = 100.0 * s / total if total else 0.0
            lines.append(
                f"  {stage:<22} {s:8.3f}s  {pct:5.1f}%"
                f"  ({self.calls[stage]} calls)"
            )
        for name in sorted(self.counts):
            lines.append(f"  {name:<22} {self.counts[name]}")
        return "\n".join(lines)


STATS = RunStats()


def enabled() -> bool:
    return os.environ.get("SNIPER_STATS", "") not in ("", "0")


@contextmanager
def maybe_profile():
    """torch.profiler trace over the wrapped region when SNIPER_PROFILE
    is set to a directory path: host activity, and the card's when one
    is present, written as ``<dir>/trace.json`` (Chrome trace)."""
    trace_dir = os.environ.get("SNIPER_PROFILE")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
