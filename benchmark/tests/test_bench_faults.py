"""A run with the timed path broken underneath comes out not correct:
an answer altered where it is produced, and half of the windows' records
left out.  The harness's look for a card is skipped (``--device cpu``)."""

from __future__ import annotations

import sys

import pytest

from bench_util import HERE, make_root, run

sys.path.insert(0, str(HERE))
from faults import FAULTS, WRAP  # noqa: E402
import run as harness  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny.passes"])
def test_broken_path_is_not_correct(root, fault, cell):
    rc, res, err = run(root, cell, seed=23,
                       prelude=FAULTS[fault] + WRAP)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res
    assert res["check"]["records_off"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny.passes"])
def test_sound_path_is_correct(root, cell):
    rc, res, err = run(root, cell, seed=23)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True and res["attempted"] >= 1
    assert res["info"]["reference_records_in_sample"] > 0


def test_sample_holds_the_blocks_and_every_planted_site():
    """The missing-record check reads every planted somatic site besides
    the blocks, so a fault that drops records meets many of them."""
    spans = harness.genome_windows([300_000, 300_000], 250_000)
    chk = {"blocks": 3, "block_bp": 20_000}
    sites = [(0, 5), (1, 299_999), (0, 123_456), (1, 7)]
    regions, in_sample = harness.check_sample(spans, chk, 2**31 + 5, sites)
    blocks = harness.sample_blocks(spans, 3, 20_000, 2**31 + 5)
    assert set(blocks) <= set(regions)
    assert all(a[2] <= b[1] for a, b in zip(regions, regions[1:])
               if a[0] == b[0])     # sorted, disjoint
    for t, p in sites:
        assert in_sample((t << harness.KEY_BITS) | p)
    for t, b, e in blocks:
        assert in_sample((t << harness.KEY_BITS) | b)
        assert in_sample((t << harness.KEY_BITS) | (e - 1))
    inside = {(t, p) for t, b, e in regions for p in range(b, e)}
    outside = next((t, p) for t in (0, 1) for p in range(0, 300_000, 997)
                   if (t, p) not in inside)
    assert not in_sample((outside[0] << harness.KEY_BITS) | outside[1])
