"""Bulk text emission: field arrays -> output lines, no record objects.

At WGS scale, building DqStats/SampleData/SniperRecord objects plus
per-field formatter calls was ~half of emit wall time.  These builders
render classic/vcf/bed text in one pass from the raw [K, 18] dqstats
rows (``output.dqstats.get_dqstats_rows`` layout: mean_baseq[4] |
mean_mapq[4] | base_occ[4] | dp4[4] | total_depth | total_mean_mapq)
and the compact field arrays (``models.somatic.COMPACT_FIELDS``).

Byte-identical to routing SniperRecord objects through
``output.formatters`` (the reference implementations of
output_classic.c / output_vcf.c / output_bed.c) — a property enforced
by tests/test_fast_emit.py across every fixture, format and precision.
``formatters.py`` stays the readable reference; this module is the
production emit path (``runner._build_records`` with ``fmt=`` set).

Copy of somatic_sniper_tpu/output/fast_emit.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

from ..constants import NT16_REV_TABLE
from .formatters import _VCF_FORMAT_STRING, _vcf_gt

# ALT column text per 4-bit alt mask (output_vcf.c: comma-joined A,C,G,T
# for the set bits; '.' when no alt allele)
_ALT_STR = tuple(
    ",".join("ACGT"[i] for i in range(4) if alts & (1 << i)) or "."
    for alts in range(16)
)


def _mv(bases: int, row, off: int) -> str:
    """print_mean_quality_values / print_base_count (dqstats.c:55-88)
    over a raw dqstats row: comma-joined row[off+i] for set bits i of
    ``bases``; '0' if none.  ``off`` selects the stat block (0 baseq,
    4 mapq, 8 base_occ)."""
    b = bases & 0xF
    if b == 0:
        return "0"
    out = [str(row[off + i]) for i in range(4) if b & (1 << i)]
    return ",".join(out)


def build_classic(names, poss, chars, rb4, f, rows_t, rows_n):
    """output_classic.c:9-55 — 26 tab-separated columns."""
    t_gt, n_gt = f["tumor_gt"], f["normal_gt"]
    t_cq, t_vaq = f["tumor_cnsq"], f["tumor_vaq"]
    n_cq, n_vaq = f["normal_cnsq"], f["normal_vaq"]
    score = f["somatic_score"]
    lines = []
    for k in range(len(poss)):
        rt, rn = rows_t[k], rows_n[k]
        r4, tg, ng = rb4[k], t_gt[k], n_gt[k]
        lines.append(
            "\t".join((
                names[k], str(poss[k] + 1), chr(chars[k]),
                NT16_REV_TABLE[tg], NT16_REV_TABLE[ng],
                str(score[k]), str(t_cq[k]), str(t_vaq[k]), str(rt[17]),
                str(n_cq[k]), str(n_vaq[k]), str(rn[17]),
                str(rt[16]), str(rn[16]),
                _mv(r4, rt, 0), _mv(r4, rt, 4), _mv(r4, rt, 8),
                _mv(~r4 & tg, rt, 0), _mv(~r4 & tg, rt, 4),
                _mv(~r4 & tg, rt, 8),
                _mv(r4, rn, 0), _mv(r4, rn, 4), _mv(r4, rn, 8),
                _mv(~r4 & ng, rn, 0), _mv(~r4 & ng, rn, 4),
                _mv(~r4 & ng, rn, 8),
            )) + "\n"
        )
    return lines


def _vcf_sample(ref4, alts, gt_i, jgt, jcq, cq, vaq, ssc_v, st, d) -> str:
    """output_vcf_sample (output_vcf.c:81-133) over a raw dqstats row.
    ``ssc_v`` < 0 prints '.' (the NORMAL sample has no somatic score)."""
    if jgt:
        gt = _vcf_gt(ref4, alts, jgt)
        igt = _vcf_gt(ref4, alts, gt_i)
        jgq = str(jcq)
    else:
        gt = igt = _vcf_gt(ref4, alts, gt_i)
        jgq = "."
    ssc = str(ssc_v) if ssc_v >= 0 else "."
    return (
        f"{gt}:{igt}:{d[16]}:{d[12]},{d[13]},{d[14]},{d[15]}:"
        f"{d[8]},{d[9]},{d[10]},{d[11]}:{cq}:{jgq}:{vaq}:"
        f"{_mv(gt_i, d, 0)}:{d[17]}:{_mv(gt_i, d, 4)}:{st}:{ssc}"
    )


def build_vcf(names, poss, chars, rb4, f, rows_t, rows_n):
    """output_vcf.c — NORMAL sample column before TUMOR."""
    t_gt, n_gt = f["tumor_gt"], f["normal_gt"]
    t_jgt, n_jgt = f["joint_tumor_gt"], f["joint_normal_gt"]
    jcq = f["joint_cnsq"]
    t_cq, t_vaq = f["tumor_cnsq"], f["tumor_vaq"]
    n_cq, n_vaq = f["normal_cnsq"], f["normal_vaq"]
    score = f["somatic_score"]
    t_st, n_st = f["tumor_status"], f["normal_status"]
    lines = []
    for k in range(len(poss)):
        r4, tg, ng = rb4[k], t_gt[k], n_gt[k]
        alts = (tg | ng) & ~r4 & 0xF
        normal = _vcf_sample(r4, alts, ng, n_jgt[k], jcq[k], n_cq[k],
                             n_vaq[k], -1, n_st[k], rows_n[k])
        tumor = _vcf_sample(r4, alts, tg, t_jgt[k], jcq[k], t_cq[k],
                            t_vaq[k], score[k], t_st[k], rows_t[k])
        lines.append(
            f"{names[k]}\t{poss[k] + 1}\t.\t{chr(chars[k])}\t"
            f"{_ALT_STR[alts]}\t.\t.\t.\t{_VCF_FORMAT_STRING}\t"
            f"{normal}\t{tumor}\n"
        )
    return lines


def build_bed(names, poss, chars, rb4, f, rows_t, rows_n):
    """output_bed.c — half-open interval, tumor genotype and depth."""
    t_gt, score = f["tumor_gt"], f["somatic_score"]
    lines = []
    for k in range(len(poss)):
        p = poss[k]
        lines.append(
            f"{names[k]}\t{p}\t{p + 1}\t"
            f"{chr(chars[k])}/{NT16_REV_TABLE[t_gt[k]]}\t"
            f"{score[k]}\t{rows_t[k][16]}\n"
        )
    return lines


LINE_BUILDERS = {
    "classic": build_classic,
    "vcf": build_vcf,
    "bed": build_bed,
}
