"""The reader of ``card_build_pct``: the share of the window's region
loads whose pileup the card built, from a run's ``STATS`` deltas, and
``None`` where the program has no such counters (a program that builds
every region on the host) or loaded no region."""

from __future__ import annotations

import importlib.util
from types import SimpleNamespace

import pytest

from bench_util import HERE

KEYS = ("native.regions_card_built", "native.regions_host_built")
STATS = {"load.region": 9.0, "native.pileup_build": 4.0,
         "native.regions_card_built": 38, "native.regions_host_built": 2}


def _read(stats):
    spec = importlib.util.spec_from_file_location(
        "m_card_build_pct", HERE / "metrics" / "card_build_pct.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(SimpleNamespace(columns=4e6, stats=dict(stats)))


def test_card_build_share_value():
    assert _read(STATS) == pytest.approx(95.0)


@pytest.mark.parametrize("stage", KEYS)
def test_card_build_share_none_without_its_counter(stage):
    assert _read({k: v for k, v in STATS.items() if k != stage}) is None


def test_card_build_share_none_without_a_region_load():
    assert _read(dict(STATS, **{k: 0 for k in KEYS})) is None
