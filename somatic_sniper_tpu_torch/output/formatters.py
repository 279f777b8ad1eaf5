"""Output formatters: classic / vcf / bed.

Byte-identical to the reference writers
(output_classic.c, output_vcf.c, output_bed.c), including the NORMAL-
before-TUMOR VCF sample order, '.' placeholders, and the masked
mean-quality printing helpers of dqstats.c:55-88.

Copy of somatic_sniper_tpu/output/formatters.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Callable, TextIO

from ..constants import NT16_REV_TABLE
from .records import HeaderData, SniperRecord, SampleData


def _masked_values(bases: int, values) -> str:
    """print_mean_quality_values / print_base_count (dqstats.c:55-88):
    comma-joined values[i] where bit i of ``bases`` is set; '0' if none."""
    out = [str(values[i]) for i in range(4) if bases & (1 << i)]
    return ",".join(out) if out else "0"


# --- classic (output_classic.c:9-55; column spec: gmt/documentation.md) ---

def classic_header(fh: TextIO, h: HeaderData) -> None:
    pass  # classic has no header (output_classic.c:6-7)


def classic_record(fh: TextIO, p: SniperRecord) -> None:
    t, n = p.tumor, p.normal
    ref4 = p.ref_base4
    fields = [
        p.seq_name,
        str(p.pos + 1),
        chr(p.ref_base),
        NT16_REV_TABLE[t.genotype],
        NT16_REV_TABLE[n.genotype],
        str(t.somatic_score),
        str(t.consensus_quality),
        str(t.variant_allele_quality),
        str(t.dqstats.total_mean_mapq),
        str(n.consensus_quality),
        str(n.variant_allele_quality),
        str(n.dqstats.total_mean_mapq),
        str(t.dqstats.total_depth),
        str(n.dqstats.total_depth),
        _masked_values(ref4, t.dqstats.mean_baseq),
        _masked_values(ref4, t.dqstats.mean_mapq),
        _masked_values(ref4, t.dqstats.base_occ),
        _masked_values(~ref4 & t.genotype, t.dqstats.mean_baseq),
        _masked_values(~ref4 & t.genotype, t.dqstats.mean_mapq),
        _masked_values(~ref4 & t.genotype, t.dqstats.base_occ),
        _masked_values(ref4, n.dqstats.mean_baseq),
        _masked_values(ref4, n.dqstats.mean_mapq),
        _masked_values(ref4, n.dqstats.base_occ),
        _masked_values(~ref4 & n.genotype, n.dqstats.mean_baseq),
        _masked_values(~ref4 & n.genotype, n.dqstats.mean_mapq),
        _masked_values(~ref4 & n.genotype, n.dqstats.base_occ),
    ]
    fh.write("\t".join(fields) + "\n")


# --- vcf (output_vcf.c) ---

_VCF_FORMAT_STRING = "GT:IGT:DP:DP4:BCOUNT:GQ:JGQ:VAQ:BQ:MQ:AMQ:SS:SSC"
_VCF_FORMAT_FIELDS = [
    ("GT", "1", "String", "Genotype"),
    ("IGT", "1", "String",
     "Genotype when called independently (only filled if called in joint "
     "prior mode)"),
    ("DP", "1", "Integer", "Total read depth"),
    ("DP4", "4", "Integer",
     "# high-quality ref-forward bases, ref-reverse, alt-forward and "
     "alt-reverse bases"),
    ("BCOUNT", "4", "Integer",
     "Occurrence count for each base at this site (A,C,G,T)"),
    ("GQ", "1", "Integer", "Genotype quality"),
    ("JGQ", "1", "Integer",
     "Joint genotype quality (only filled if called in join prior mode)"),
    ("VAQ", "1", "Integer", "Variant allele quality"),
    ("BQ", ".", "Integer", "Average base quality"),
    ("MQ", "1", "Integer", "Average mapping quality across all reads"),
    ("AMQ", ".", "Integer",
     "Average mapping quality for each allele present in the genotype"),
    ("SS", "1", "Integer",
     "Variant status relative to non-adjacent Normal, 0=wildtype,"
     "1=germline,2=somatic,3=LOH,4=unknown"),
    ("SSC", "1", "Integer", "Somatic Score"),
]


def vcf_header(fh: TextIO, h: HeaderData) -> None:
    filedate = time.strftime("%Y%m%d", time.localtime())
    fh.write("##fileformat=VCFv4.1\n")
    fh.write(f"##fileDate={filedate}\n")
    fh.write("##phasing=none\n")
    fh.write(f"##reference=file://{h.refseq}\n")
    for fid, num, typ, desc in _VCF_FORMAT_FIELDS:
        fh.write(
            f'##FORMAT=<ID={fid},Number={num},Type={typ},'
            f'Description="{desc}">\n'
        )
    fh.write(
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
        f"{h.normal_sample_id}\t{h.tumor_sample_id}\n"
    )


@lru_cache(maxsize=None)  # <= 16^3 distinct inputs, hit per record
def _vcf_gt(ref_base: int, alts: int, gt: int) -> str:
    """output_vcf_gt (output_vcf.c:46-79)."""
    allele_count = bin(gt & 0xF).count("1")
    parts = []
    out_count = 0
    if gt & ref_base:
        if allele_count == 1:
            return "0/0"
        parts.append("0")
        out_count += 1
    gt &= ~ref_base
    allele_idx = 0
    for i in range(4):
        value = 1 << i
        if alts & value:
            allele_idx += 1
        if gt & value:
            if allele_count == 1:
                return f"{allele_idx}/{allele_idx}"
            if out_count > 0:
                parts.append("/")
            parts.append(str(allele_idx))
            out_count += 1
    return "".join(parts)


def _vcf_sample(ref4: int, alts: int, s: SampleData) -> str:
    """output_vcf_sample (output_vcf.c:81-133)."""
    d = s.dqstats
    if s.joint_genotype:
        gt = _vcf_gt(ref4, alts, s.joint_genotype)
        igt = _vcf_gt(ref4, alts, s.genotype)
    else:
        gt = igt = _vcf_gt(ref4, alts, s.genotype)
    jgq = str(s.joint_consensus_quality) if s.joint_genotype else "."
    ssc = str(s.somatic_score) if s.somatic_score >= 0 else "."
    return (
        f"{gt}:{igt}:{d.total_depth}:"
        f"{d.dp4[0]},{d.dp4[1]},{d.dp4[2]},{d.dp4[3]}:"
        f"{d.base_occ[0]},{d.base_occ[1]},{d.base_occ[2]},{d.base_occ[3]}:"
        f"{s.consensus_quality}:{jgq}:{s.variant_allele_quality}:"
        f"{_masked_values(s.genotype, d.mean_baseq)}:"
        f"{d.total_mean_mapq}:"
        f"{_masked_values(s.genotype, d.mean_mapq)}:"
        f"{s.variant_status}:{ssc}"
    )


def vcf_record(fh: TextIO, p: SniperRecord) -> None:
    alts = (p.tumor.genotype | p.normal.genotype) & ~p.ref_base4
    alt_str = ",".join(
        NT16_REV_TABLE[1 << i] for i in range(4) if alts & (1 << i)
    ) or "."
    fh.write(
        f"{p.seq_name}\t{p.pos + 1}\t.\t{chr(p.ref_base)}\t{alt_str}\t"
        f".\t.\t.\t{_VCF_FORMAT_STRING}\t"
        f"{_vcf_sample(p.ref_base4, alts, p.normal)}\t"
        f"{_vcf_sample(p.ref_base4, alts, p.tumor)}\n"
    )


# --- bed (output_bed.c) ---

def bed_header(fh: TextIO, h: HeaderData) -> None:
    fh.write("#CHROM\tSTART\tSTOP\tREF/ALT\tSOMATIC_SCORE\tTUMOR_DEPTH\n")


def bed_record(fh: TextIO, p: SniperRecord) -> None:
    fh.write(
        f"{p.seq_name}\t{p.pos}\t{p.pos + 1}\t"
        f"{chr(p.ref_base)}/{NT16_REV_TABLE[p.tumor.genotype]}\t"
        f"{p.tumor.somatic_score}\t{p.tumor.dqstats.total_depth}\n"
    )


FORMATTERS: dict[str, tuple[Callable, Callable]] = {
    "classic": (classic_header, classic_record),
    "vcf": (vcf_header, vcf_record),
    "bed": (bed_header, bed_record),
}


def get_formatter(name: str) -> tuple[Callable, Callable]:
    if name not in FORMATTERS:
        raise ValueError(
            f"unknown output format '{name}' "
            f"(available: {', '.join(FORMATTERS)})"
        )
    return FORMATTERS[name]
