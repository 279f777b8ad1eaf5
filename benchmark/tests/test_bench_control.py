"""The control: the plain reference put in the program's place in
bfloat16 (the precision below the configuration's float32) has to come
out as not correct; the exact reference in its place as correct."""

from __future__ import annotations

import sys

from bench_util import HERE, TINY

sys.path.insert(0, str(HERE))
import check  # noqa: E402
import pairgen  # noqa: E402
from reference import caller, model  # noqa: E402


def _compare(p, flags, precision):
    prm = model.params_from_flags(flags)
    reads = caller.read_pair(p.tumor, p.normal, p.ref)
    ref = caller.call(None, None, None, prm, reads=reads)
    prog = caller.call(None, None, None, prm, reads=reads, precision=precision)
    tid_of = {"ctg1": 0, "ctg2": 1}
    return check.compare(list(prog.lines.values()), ref, lambda k: True,
                         tid_of, prm.min_qual, 1)


def test_bf16_control_fails_and_exact_passes(tmp_path):
    p = pairgen.generate(tmp_path, dict(TINY, contig_len=100_000), 21, workers=2)
    flags = ["-q", "1", "-G", "-L", "-F", "vcf"]
    same = _compare(p, flags, "exact")
    assert same["records_off"] == 0 and same["program_records"] > 100
    ctl = _compare(p, flags, "bf16")
    assert ctl["records_off"] > 0, ctl
