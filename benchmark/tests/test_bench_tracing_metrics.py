"""The readers of the host-load metrics: each gives its value from a
run's ``STATS`` deltas, and ``None`` where the program has no such stage
(a program that predates the stage)."""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest

from bench_util import HERE

STATS = {
    "load_wait": 2.0, "load_wait.block": 1.5, "load.region": 9.0,
    "native.read": 0.25, "native.bgzf_scan": 0.25, "native.inflate": 1.0,
    "native.record_scan": 1.0, "native.pileup_build": 4.0,
    "native.pure_flags": 1.0, "load_pool.busy": 12.0,
    "load_pool.open": 15.0, "driver.open": 0.1,
}
MCOL = 4.0     # columns of the fake run, in millions

CASES = [
    ("load_block_s", 1.5 / MCOL, ["load_wait.block"]),
    ("load_region_s", 9.0 / MCOL, ["load.region"]),
    ("inflate_s", 1.5 / MCOL,
     ["native.read", "native.bgzf_scan", "native.inflate"]),
    ("pileup_build_s", 6.0 / MCOL,
     ["native.record_scan", "native.pileup_build", "native.pure_flags"]),
    ("load_pool_busy_pct", 80.0, ["load_pool.busy", "load_pool.open"]),
    ("driver_open_s", 0.1 / MCOL, ["driver.open"]),
]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(stats):
    return SimpleNamespace(columns=MCOL * 1e6, stats=dict(stats))


@pytest.mark.parametrize("name,want,reads", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_value(name, want, reads):
    assert _reader(name)(_run(STATS)) == pytest.approx(want)


@pytest.mark.parametrize("name,want,reads", CASES,
                         ids=[c[0] for c in CASES])
def test_reader_none_without_its_stage(name, want, reads):
    read = _reader(name)
    for stage in reads:
        stats = {k: v for k, v in STATS.items() if k != stage}
        assert read(_run(stats)) is None, stage


def test_pool_share_none_on_a_pool_never_open():
    assert _reader("load_pool_busy_pct")(
        _run(dict(STATS, **{"load_pool.open": 0.0}))) is None
