"""The plain reference against the original tool's golden VCFs, and its
monomorphic-column shortcut against the full computation."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from bench_util import HERE, REPO, TINY

sys.path.insert(0, str(HERE))
from reference import caller, model  # noqa: E402

E2E = REPO / "tests" / "data" / "e2e"
GOLDEN = [
    ("sim1", "expected.vcf", []),
    ("sim1", "expected.joint.vcf", ["-J", "-s", "0.001"]),
    ("sim1", "expected.nopriors.vcf", ["-p"]),
    ("sim1", "expected.loh.vcf", ["-L", "-G", "-Q", "0"]),
    ("sim2_deep", "expected.vcf", []),
    ("sim3_params", "expected.T9.vcf", ["-T", "0.9", "-r", "0.002", "-Q", "0"]),
    ("sim4_adversarial", "expected.vcf", ["-Q", "0"]),
    ("sim4_adversarial", "expected.joint.vcf", ["-J", "-s", "0.001", "-Q", "0"]),
    ("sim4_adversarial", "expected.loh.vcf", ["-L", "-G", "-Q", "0"]),
]


def _call(d: Path, flags, **kw):
    return caller.call(d / "tumor.bam", d / "normal.bam", d / "ref.fa",
                       model.params_from_flags(flags), **kw)


@pytest.mark.parametrize("case,golden,flags", GOLDEN)
def test_reference_matches_golden(case, golden, flags):
    d = E2E / case
    got = _call(d, flags)
    want = [ln for ln in (d / golden).read_text().splitlines(True)
            if not ln.startswith("#")]
    assert [got.lines[k] for k in sorted(got.lines)] == want


@pytest.mark.parametrize("case", ["sim1", "sim4_adversarial"])
def test_shortcut_changes_nothing_on_goldens(case):
    fast = _call(E2E / case, ["-Q", "0"])
    full = _call(E2E / case, ["-Q", "0"], shortcut=False)
    assert fast.lines == full.lines and fast.near == full.near
    assert fast.scored < full.scored


def test_shortcut_changes_nothing_on_a_generated_pair(tmp_path):
    import pairgen

    data = dict(TINY, contig_len=60_000)
    p = pairgen.generate(tmp_path, data, 5, workers=2)
    flags = ["-q", "1", "-Q", "0"]
    fast = _call(p.dir, flags)
    full = _call(p.dir, flags, shortcut=False)
    assert fast.lines == full.lines and len(fast.lines) > 50
    assert fast.scored < full.scored / 2


def test_regions_give_the_whole_run_restricted(tmp_path):
    """Scoring some blocks and single columns gives the whole run's
    lines there, and the near-threshold lines are those of score Q-1."""
    d = E2E / "sim1"
    whole = _call(d, ["-Q", "30"])
    keys = sorted(whole.lines)
    t0 = keys[0] >> 40
    regions = [(t0, 0, 300), (t0, (keys[-1] & 0xFFFFFFFFFF), (keys[-1] & 0xFFFFFFFFFF) + 1)]
    regions = sorted(set(regions))
    part = _call(d, ["-Q", "30"], regions=regions)
    inside = {k: v for k, v in whole.lines.items()
              if any(k >> 40 == t and b <= (k & 0xFFFFFFFFFF) < e
                     for t, b, e in regions)}
    assert part.lines == inside
    for line in whole.near.values():
        assert int(line.split("\t")[10].split(":")[-1]) == 29
