"""The port's host-load spans and counters (``utils/stats.STATS``), on a
small windowed CPU pair (sim1: two 3 kb contigs, 1 kb windows).

Inside ``parallel/sharded.call_pair_windows``: ``load.region`` (a region
load on the pool, one a sample and a window), ``load.carry`` (the quirk
carry's backward scan, nested in it), ``load_wait.block`` (the main
thread blocked on a window's loads, nested in ``load_wait``),
``driver.open`` (a call's set-up), ``load_pool.busy`` and
``load_pool.open``.  From the native loader: its cumulative phase
seconds and inflate counters as ``native.*`` entries, read without
reset.  Under ``SNIPER_PROFILE`` the windowed CLI writes the span log
into its ``trace.json`` on the trace's clock.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from somatic_sniper_tpu_torch.io import native, native_api  # noqa: E402
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402
from somatic_sniper_tpu_torch.parallel.sharded import (  # noqa: E402
    call_pair_windows, genome_windows)
from somatic_sniper_tpu_torch.utils import stats  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS, RunStats  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WINDOW = 1000
PHASES = [f"native.{p}" for p in native.LOAD_PHASES]
COUNTERS = [f"native.{c}"
            for c in native.INFLATE_COUNTERS + native.BUILD_COUNTERS]


def _pair(data_dir):
    d = data_dir / "e2e" / "sim1"
    return str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa")


def _run(data_dir, **kw):
    """One windowed call; returns (lines, its STATS deltas, its calls'
    deltas)."""
    if native.get_lib() is None:
        pytest.skip("no native library (g++)")
    s0, c0 = STATS.snapshot(), dict(STATS.calls)
    lines = []
    for _wi, _w, ls in call_pair_windows(
            *_pair(data_dir), precision="fast", fmt="vcf",
            window_size=WINDOW, device="cpu", **kw):
        lines.extend(ls)
    s1, c1 = STATS.snapshot(), dict(STATS.calls)
    delta = {k: v - s0.get(k, 0) for k, v in s1.items()}
    calls = {k: v - c0.get(k, 0) for k, v in c1.items()}
    return lines, delta, calls


def _n_windows(data_dir):
    from somatic_sniper_tpu_torch.io.bam import read_bam_header

    return len(genome_windows(read_bam_header(_pair(data_dir)[0])
                              .ref_lengths, WINDOW))


def _hold_loads_until_waited(monkeypatch) -> threading.Event:
    """Hold the pool's region loads until the main thread waits on one,
    so that it blocks (``load_wait.block``) however fast the loads are;
    the event is set once it has."""
    waited = threading.Event()
    load, wait = native_api.load_region_and_columnize, sharded.futures_wait

    def held_load(*args, **kw):
        if threading.current_thread() is not threading.main_thread():
            waited.wait(60)
        return load(*args, **kw)

    def marked_wait(*args, **kw):
        waited.set()
        return wait(*args, **kw)

    monkeypatch.setattr(native_api, "load_region_and_columnize", held_load)
    monkeypatch.setattr(sharded, "futures_wait", marked_wait)
    return waited


@pytest.mark.parametrize("pool", ["2", "4"])
def test_load_spans_per_call(monkeypatch, data_dir, pool):
    """Two region loads a window, one set-up a call; each span within the
    one it is nested in, the pool's busy time within its open time, the
    native phases within the loads, on a narrow pool (plan on the main
    thread) and a wide one (plan on the pool).  The loads are held until
    the main thread waits on one."""
    monkeypatch.setenv("SNIPER_LOAD_POOL", pool)
    waited = _hold_loads_until_waited(monkeypatch)
    _, d, calls = _run(data_dir)
    assert waited.is_set()
    n = _n_windows(data_dir)
    assert calls["load.region"] == 2 * n
    assert calls["load.carry"] == 2       # both samples at ctg2's start
    assert calls["driver.open"] == 1
    assert calls["load_pool.open"] == 1
    # every load, and on a wide pool every plan, is a pool task
    assert calls["load_pool.busy"] == 2 * n + (n if int(pool) >= 3 else 0)
    assert 0 < d["load.carry"] <= d["load.region"]
    assert 0 < d["load_wait.block"] <= d["load_wait"]
    assert 0 < sum(d[p] for p in PHASES) <= d["load.region"]
    assert d["load.region"] <= d["load_pool.busy"] <= d["load_pool.open"]
    assert d["native.bytes_inflated"] > 0
    assert (d["native.blocks_libdeflate"] + d["native.blocks_zlib"]) > 0


def test_native_counters_read_without_reset(data_dir):
    """A window's delta of the ``native.*`` entries equals the loader's
    own cumulative counters' delta, whatever resets another reader makes
    in between; ``reset`` takes a baseline and leaves the loader as it
    is."""
    _run(data_dir)  # the library is loaded and its source registered
    lib = native.get_lib()
    raw0 = native.load_counters(lib)
    s0 = STATS.snapshot()
    other = RunStats()
    other.add_source(functools.partial(native.load_counters, lib))
    _, d, _ = _run(data_dir)
    other.reset()
    assert other.snapshot()["native.bytes_inflated"] == 0
    raw1 = native.load_counters(lib)
    s1 = STATS.snapshot()
    for k in PHASES:
        assert s1[k] - s0[k] == pytest.approx(raw1[0][k] - raw0[0][k])
    for k in COUNTERS:
        assert s1[k] - s0[k] == raw1[1][k] - raw0[1][k]
    assert d["native.bytes_inflated"] > 0
    fresh = RunStats()
    fresh.add_source(functools.partial(native.load_counters, lib))
    fresh.reset()
    _, d2, _ = _run(data_dir)
    assert fresh.snapshot()["native.bytes_inflated"] == \
        d2["native.bytes_inflated"] == d["native.bytes_inflated"]


def _harness():
    spec = importlib.util.spec_from_file_location(
        "bench_run_for_spans", REPO / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_harness_host_spans_records_the_load_spans(data_dir, monkeypatch):
    """The benchmark's ``host_spans`` swaps ``STATS.timer`` for a
    one-argument wrapper: the new spans pass through it, from the main
    thread and the pool's.  The pool's loads are held until the main
    thread waits on one, so that it blocks (``load_wait.block``) however
    fast the loads are."""
    waited = _hold_loads_until_waited(monkeypatch)
    run = _harness()
    with run.host_spans(STATS, True) as spans:
        lines, _, _ = _run(data_dir)
    assert waited.is_set()
    names = {n for n, _, _ in spans}
    assert {"load.region", "load.carry", "load_wait.block",
            "driver.open", "load_wait"} <= names
    assert "timer" not in vars(STATS)   # the wrapper is taken off again
    assert all(a <= b for _, a, b in spans)
    assert lines


def test_summary_shares_of_wall():
    """Each stage's seconds, share of the run's wall and calls; stages
    run off the main thread, or recorded as thread-seconds, marked."""
    s = RunStats()
    with s.timer("outer"):
        with s.timer("inner"):
            time.sleep(0.01)
    worker = threading.Thread(target=lambda: s.record("busy", 0.5))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    s.record("open", 1.0, threads=True)
    s.add("things", 3)
    lines = s.summary().splitlines()
    assert lines[0].startswith("[sniper-tpu stats] wall ")
    row = {ln.split()[0]: ln for ln in lines[1:]}
    assert "% of wall" in row["inner"] and "(1 calls)" in row["inner"]
    assert row["busy"].endswith("thread-s")
    assert row["open"].endswith("thread-s")
    assert not row["outer"].endswith("thread-s")
    assert row["things"].split() == ["things", "3"]
    assert float(row["outer"].split()[1][:-1]) >= 0.01


def test_span_log_parents_and_context_under_threads():
    """Many threads, each nesting spans in its own context: every span
    logs its own thread's parent and id, and no count is lost."""
    s = RunStats()
    s.start_log()
    n_threads, n_iter = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        with s.context(window=i):
            for _ in range(n_iter):
                with s.timer("outer"):
                    with s.timer("inner"):
                        pass

    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    log = s.stop_log()
    assert s.calls["outer"] == s.calls["inner"] == n_threads * n_iter
    assert len(log) == 2 * n_threads * n_iter
    tids = {}
    for stage, tid, tag, parent, t0, t1 in log:
        assert tag[0] == "window"
        assert tids.setdefault(tag[1], tid) == tid
        assert parent == ("outer" if stage == "inner" else None)
        assert t0 <= t1
    assert "span_log_dropped" not in s.counts


def test_span_log_is_bounded():
    s = RunStats()
    s.start_log(cap=3)
    for _ in range(5):
        with s.timer("x"):
            pass
    assert len(s.stop_log()) == 3
    assert s.counts["span_log_dropped"] == 2
    with s.timer("x"):   # the log is off again
        pass
    assert s.stop_log() == []


def test_windowed_cli_profile_holds_the_span_log(data_dir, tmp_path):
    """SNIPER_PROFILE on the windowed CLI: one ``trace.json`` holding the
    torch.profiler trace and the span log as ``X`` events, with window
    ids, whose times map back (``sniperAlign``) inside the run's own
    ``perf_counter`` bounds (CLOCK_MONOTONIC, one clock across
    processes)."""
    if native.get_lib() is None:
        pytest.skip("no native library (g++)")
    trace_dir = tmp_path / "trace"
    env = dict(os.environ, SNIPER_PROFILE=str(trace_dir),
               PYTHONPATH=str(REPO))
    t0 = time.perf_counter_ns()
    r = subprocess.run(
        [sys.executable, "-m", "somatic_sniper_tpu_torch.cli.main",
         "--device", "cpu", "--precision", "fast", "-F", "vcf",
         "--window-size", str(WINDOW), "--shard-index", "0",
         "-f", _pair(data_dir)[2], *_pair(data_dir)[:2],
         str(tmp_path / "w.vcf")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    t1 = time.perf_counter_ns()
    assert r.returncode == 0, r.stderr
    trace = json.loads((trace_dir / "trace.json").read_text())
    align = trace["sniperAlign"]
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "sniper"]
    names = {e["name"] for e in ours}
    assert {"driver.open", "load.region", "load.carry", "load_wait",
            "plan", "emit"} <= names
    windows = {e["args"]["window"] for e in ours
               if e["name"] == "load.region"}
    assert windows == set(range(6))
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ours)
    assert any(e.get("name") == stats.ALIGN_MARK
               for e in trace["traceEvents"])
    for e in ours:
        start = (e["ts"] - align["ts"]) * 1e3 + align["perf_counter_ns"]
        assert t0 - 1e3 <= start <= start + e["dur"] * 1e3 <= t1 + 1e3
    carry = [e for e in ours if e["name"] == "load.carry"]
    assert carry and all(e["args"]["parent"] == "load.region"
                         for e in carry)
    assert [ln for ln in (tmp_path / "w.vcf").read_text().splitlines()
            if not ln.startswith("#")]
