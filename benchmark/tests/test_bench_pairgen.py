"""The pair generator: determinism per seed, variant rates, reads that
no filter drops, and an index equal to the one the program builds."""

from __future__ import annotations

import sys

import numpy as np

from bench_util import HERE, REPO, TINY

sys.path.insert(0, str(HERE))
sys.path.insert(0, str(REPO))
import pairgen  # noqa: E402
from reference.bam import read_bam  # noqa: E402

SMALL = dict(TINY, contig_len=80_000)


def _bytes(p):
    return [f.read_bytes() for f in (p.ref, p.tumor, p.normal,
                                     p.tumor.with_suffix(".bam.bai"))]


def test_same_seed_same_bytes_any_workers(tmp_path):
    a = pairgen.generate(tmp_path / "a", SMALL, 2**31 + 17, workers=1)
    b = pairgen.generate(tmp_path / "b", SMALL, 2**31 + 17, workers=3)
    c = pairgen.generate(tmp_path / "c", SMALL, 2**31 + 18, workers=2)
    assert _bytes(a) == _bytes(b)
    assert _bytes(a)[1] != _bytes(c)[1]


def test_variant_rates_and_depth(tmp_path):
    data = dict(SMALL, contig_len=400_000)
    p = pairgen.generate(tmp_path, data, 9, workers=2)
    L = data["n_contigs"] * data["contig_len"]
    for got, rate in ((p.somatic_sites, data["somatic_rate"]),
                      (p.germline_sites, data["germline_rate"])):
        want = rate * L
        assert abs(got - want) < 5 * want ** 0.5, (got, want)
    assert abs(p.mean_depth - data["tumor_depth"]) < 0.01
    cols = p.window_columns(250_000)
    assert len(cols) == 4 and sum(cols) == sum(int(s.sum()) for s in p.shared)


def test_no_read_is_filtered(tmp_path):
    """Every read passes -q 1 and the default flag mask, so the mean
    kept depth of the roofline is the generated depth."""
    p = pairgen.generate(tmp_path, SMALL, 4, workers=2)
    for bam in (p.tumor, p.normal):
        r = read_bam(bam)
        assert len(r.pos) == p.n_reads[bam.name != "tumor.bam"]
        assert (r.mapq >= 1).all() and not (r.flag & 0x704).any()
        assert (r.cigar == (150 << 4)).all() and (r.l_seq == 150).all()


def test_index_equals_the_programs(tmp_path):
    from somatic_sniper_tpu_torch.io import bai

    p = pairgen.generate(tmp_path, SMALL, 6, workers=2)
    for bam in (p.tumor, p.normal):
        ours = bai.load_index(str(bam) + ".bai")
        theirs = bai.build_index(bam)
        for a, b in zip(ours.refs, theirs.refs):
            assert sorted(a.bins) == sorted(b.bins)
            for k in a.bins:
                ca, cb = np.asarray(a.bins[k]), np.asarray(b.bins[k])
                # the last chunk may end at the EOF block or after it
                assert (ca[:, 0] == cb[:, 0]).all()
                assert (ca[:-1, 1] == cb[:-1, 1]).all()
            assert (a.linear == b.linear).all()
