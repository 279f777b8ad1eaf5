"""The comparison that decides ``correct``: the program's VCF records
against the plain reference's, under the fast-precision contract.

The field policy is a frozen copy of ``diff_records`` in
somatic_sniper_tpu_torch/utils/contract.py (VCF part): CHROM POS ID REF
ALT QUAL FILTER INFO FORMAT exact; per sample GT IGT DP DP4 BCOUNT BQ MQ
AMQ SS exact; GQ JGQ VAQ SSC within the configuration's
``phred_tolerance`` ('.' only against '.').  Since the somatic score may
move by that much, a record at the ``-Q`` threshold may rightly be
present on one side only: a reference record of score below ``-Q`` +
tolerance that the program left out, or a program record where the
reference scores below ``-Q`` by at most the tolerance (the reference's
line there must then match).

Every program record is held to the reference at its column; every
reference record of the sampled blocks must be among the program's.
``records_off`` counts the records beyond the contract; ``loose_pct`` is
the share of the program's records that needed the tolerance at all.
"""

from __future__ import annotations

FIELDS = "GT:IGT:DP:DP4:BCOUNT:GQ:JGQ:VAQ:BQ:MQ:AMQ:SS:SSC".split(":")
LOOSE = {"GQ", "JGQ", "VAQ", "SSC"}


def line_key(line: str, tid_of: dict) -> int:
    chrom, pos = line.split("\t", 2)[:2]
    return (tid_of[chrom] << 40) | (int(pos) - 1)


def ssc(line: str) -> int:
    return int(line.rstrip("\n").split("\t")[10].split(":")[-1])


def within(prog: str, ref: str, tol: int) -> bool:
    """``prog`` equals ``ref`` but for the loose fields, each within
    ``tol``."""
    if prog == ref:
        return True
    a, b = prog.rstrip("\n").split("\t"), ref.rstrip("\n").split("\t")
    if len(a) != len(b) or a[:9] != b[:9] or len(a) != 11:
        return False
    for sa, sb in zip(a[9:], b[9:]):
        fa, fb = sa.split(":"), sb.split(":")
        if len(fa) != len(FIELDS) or len(fb) != len(FIELDS):
            return False
        for name, x, y in zip(FIELDS, fa, fb):
            if x == y:
                continue
            if name not in LOOSE or "." in (x, y) or abs(int(x) - int(y)) > tol:
                return False
    return True


def compare(prog_lines, ref, in_sample, tid_of: dict, min_qual: int,
            tol: int) -> dict:
    """Counts of the comparison.  ``prog_lines``: the program's records;
    ``ref``: the reference's ``Result`` over the sampled blocks and every
    column the program emitted; ``in_sample(key)``: whether a key lies in
    the sampled blocks."""
    prog = {}
    dup = 0
    bad = 0
    for ln in prog_lines:
        try:
            k = line_key(ln, tid_of)
        except (KeyError, ValueError, IndexError):
            bad += 1
            continue
        dup += k in prog
        prog[k] = ln
    off = dup + bad
    loose = 0
    for k, ln in prog.items():
        r = ref.lines.get(k)
        if r is None:
            r = ref.near.get(k)
        try:
            ok = r is not None and within(ln, r, tol) and ssc(ln) >= min_qual
        except (ValueError, IndexError):
            ok = False
        off += not ok
        loose += ok and ln != r
    missed = tolerated = 0
    for k, r in ref.lines.items():
        if k in prog or not in_sample(k):
            continue
        if ssc(r) - tol < min_qual:
            tolerated += 1
        else:
            missed += 1
    return {"records_off": off + missed,
            "loose_pct": 100.0 * loose / len(prog) if prog else 0.0,
            "program_records": len(prog),
            "reference_records_in_sample": sum(map(in_sample, ref.lines)),
            "loose_differences": loose, "threshold_tolerated": tolerated}
