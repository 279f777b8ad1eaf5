"""Fast-mode output contract checker (shared by tests and bench).

Project invariant: fast (f32 device) mode makes the same genotype
calls as exact mode; phred-scaled quality values may differ by at most
±1 where an f32 class sum lands on a quantization boundary.  The
reference's own contract test is the golden VCF diff
(reference integration-test/test_sniper.py:19); this generalizes it to
a field-policy diff between fast and exact output.

Field policy
  vcf:     CHROM POS ID REF ALT QUAL FILTER INFO FORMAT exact;
           per-sample GT/IGT/DP/DP4/BCOUNT/BQ/MQ/AMQ/SS exact,
           GQ/JGQ/VAQ/SSC within ±1 ('.' must match '.').
  classic: positions/genotypes/depth/dqstats columns exact;
           somatic score + consensus/variant qualities within ±1.
  bed:     somatic score within ±1; everything else exact.

Violations raise AssertionError; the return value lists the tolerated
±1 boundary diffs.  :func:`hist` compresses that list into a per-field
delta histogram (e.g. ``{"GQ+1": 7, "VAQ-1": 3}``) for the bench JSON,
so a future quantization regression shows up as a new class or a count
jump instead of hiding inside an opaque total.

Copy of somatic_sniper_tpu/utils/contract.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

# colon-field policy for the 13 VCF FORMAT fields
_VCF_PM1 = {"GQ", "JGQ", "VAQ", "SSC"}
_VCF_FIELDS = "GT:IGT:DP:DP4:BCOUNT:GQ:JGQ:VAQ:BQ:MQ:AMQ:SS:SSC".split(":")

# classic 26 columns (0-based): ±1 on score/cnsq/vaq columns
_CLASSIC_PM1 = {5, 6, 7, 9, 10}
# bed: col 4 = somatic score
_BED_PM1 = {4}


def _pm1(a: str, b: str) -> bool:
    if a == b:
        return True
    if a == "." or b == ".":
        return False
    return abs(int(a) - int(b)) <= 1


def hist(tolerated) -> dict[str, int]:
    """Per-field signed-delta histogram of :func:`diff_records` output.

    Keys are ``"<field><+/-delta>"`` — field is the FORMAT name for vcf
    or ``col<N>`` for classic/bed.  Every key a correct fast path can
    produce is a ±1 on one of the policy fields; anything else would
    have raised inside diff_records already, so the histogram's job is
    visibility (which field, which direction, how many), not policing.
    """
    out: dict[str, int] = {}
    for _key, field, fast_v, gold_v in tolerated:
        name = field if isinstance(field, str) else f"col{field}"
        delta = int(fast_v) - int(gold_v)
        k = f"{name}{delta:+d}"
        out[k] = out.get(k, 0) + 1
    return out


def diff_records(fast: list[str], gold: list[str], fmt: str):
    """Return the tolerated ±1 diffs; assert everything else equal.

    Each tolerated diff is (record_key, field_name, fast_val, gold_val).
    """
    assert len(fast) == len(gold), (
        f"record count differs: fast {len(fast)} vs exact {len(gold)}"
    )
    tolerated = []
    for lf, lg in zip(fast, gold):
        if lf == lg:
            continue
        assert not lf.startswith("#") and not lg.startswith("#"), (
            f"header line differs:\n{lf}\n{lg}"
        )
        cf, cg = lf.split("\t"), lg.split("\t")
        assert len(cf) == len(cg), f"column count differs:\n{lf}\n{lg}"
        key = ":".join(cf[:2])
        if fmt == "vcf":
            assert cf[:9] == cg[:9], f"fixed VCF fields differ at {key}"
            for si in (9, 10):  # NORMAL, TUMOR sample columns
                ff, fg = cf[si].split(":"), cg[si].split(":")
                for name, a, b in zip(_VCF_FIELDS, ff, fg):
                    if a == b:
                        continue
                    assert name in _VCF_PM1 and _pm1(a, b), (
                        f"{key} sample {si}: {name} {a} vs {b}"
                    )
                    tolerated.append((key, name, a, b))
        else:
            pm1 = _CLASSIC_PM1 if fmt == "classic" else _BED_PM1
            for i, (a, b) in enumerate(zip(cf, cg)):
                if a == b:
                    continue
                assert i in pm1 and _pm1(a, b), (
                    f"{key} column {i}: {a!r} vs {b!r}"
                )
                tolerated.append((key, i, a, b))
    return tolerated
