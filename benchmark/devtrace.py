"""Device activity read from a torch.profiler Chrome trace.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events (``ts`` and ``dur`` in microseconds).  Busy time is
the length of their union inside the window; idle gaps are the holes of
that union, each labelled by the innermost host span open at its middle
(the program's ``STATS`` stages, recorded by the harness).
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path) -> list:
    with open(path) as fh:
        data = json.load(fh)
    return data["traceEvents"] if isinstance(data, dict) else data


def find_ts(events, name: str):
    """``ts`` of the first event called ``name``, or None."""
    for e in events:
        if e.get("name") == name and "ts" in e:
            return float(e["ts"])
    return None


def device_ops(events, lo: float, hi: float) -> list:
    """(start, end, name) of the device operations that overlap [lo, hi),
    clipped to it."""
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if t > lo and s < hi:
            out.append((max(s, lo), min(t, hi), e.get("name", "?")))
    return out


def union(ops) -> list:
    merged = []
    for s, t, _ in sorted(ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def summarize(events, lo: float, hi: float, spans=()) -> dict:
    """Busy seconds, the summed seconds of every device operation, the
    ten operations that took most time and the ten longest idle gaps of
    the window [lo, hi) (trace microseconds).  ``spans``: (stage, start,
    end) host spans in trace microseconds."""
    ops = device_ops(events, lo, hi)
    merged = union(ops)
    by_name = defaultdict(float)
    for s, t, name in ops:
        by_name[name] += (t - s) * 1e-6
    gaps, prev = [], lo
    for s, t in merged + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)

    def label(a, b):
        mid = 0.5 * (a + b)
        best = None
        for stage, s, t in spans:
            if s <= mid < t and (best is None or t - s < best[1]):
                best = (stage, t - s)
        return f"host:{best[0]}" if best else "host:harness"

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": sum(t - s for s, t in merged) * 1e-6,
        "op_s": sum(by_name.values()),
        "ops": len(ops),
        "device_ops": sorted(([n, v] for n, v in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(a, b), (b - a) * 1e-6] for a, b in gaps[:10]],
    }
