"""Basic post-call filtering — port of the reference's snpfilter.pl.

Filters bam-somaticsniper output (classic or VCF, auto-detected) against
an optional samtools-pileup indel file, SNV density windows, and quality
thresholds.  Reference: src/scripts/snpfilter.pl (defaults :29-39, indel
load :85-95, VCF/classic parse :108-134, density window :170-198).

Copy of somatic_sniper_tpu/scripts/snpfilter.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys

IUB_AS_STRING = {
    "A": "AA", "C": "CC", "G": "GG", "T": "TT",
    "M": "AC", "K": "GT", "Y": "CT", "R": "AG", "W": "AT", "S": "CG",
    "D": "AGT", "B": "CGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}


def is_loh(tumor: str, normal: str) -> bool:
    """snpfilter.pl:212-220: normal is het and tumor allele(s) subset."""
    if normal in "MKYRWS" and tumor in IUB_AS_STRING.get(normal, ""):
        return True
    return False


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="snpfilter",
        description="Basic filtering for SomaticSniper output "
                    "(port of snpfilter.pl)",
    )
    p.add_argument("--snp-file", required=True)
    p.add_argument("--lq-output")
    p.add_argument("--min-mapping-quality", type=int, default=40)
    p.add_argument("--min-cns-qual", type=int, default=20)
    p.add_argument("--min-read-depth", type=int, default=3)
    p.add_argument("--max-read-depth", type=int, default=100_000_000)
    p.add_argument("--snp-win-size", type=int, default=10)
    p.add_argument("--max-snp-per-win", type=int, default=2)
    p.add_argument("--min-snp-qual", type=int, default=20)
    p.add_argument("--out-file")
    p.add_argument("--indel-file")
    p.add_argument("--indel-win-size", type=int, default=10)
    p.add_argument("--min-indel-score", type=int, default=50)
    p.add_argument("--tumor-variant-only", action="store_true")
    p.add_argument("--include-loh", action="store_true")
    return p


def load_indel_filter(path: str, min_indel_score: float) -> set:
    """snpfilter.pl:85-95: samtools pileup indel sites above score."""
    sites = set()
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) < 6:
                continue
            chrom, pos, ind_id, indel_seq, score = (
                f[0], f[1], f[2], f[3], f[5]
            )
            try:
                score_v = float(score)
            except ValueError:
                score_v = 0.0  # perl numifies junk to 0 (with a warning)
            if ind_id != "*" or indel_seq == "*/*" or \
                    score_v < min_indel_score:
                continue
            sites.add((chrom, int(pos)))
    return sites


def parse_line(line: str, is_vcf: bool):
    """Extract the filter-relevant fields (snpfilter.pl:120-135)."""
    f = line.rstrip("\n").split("\t")
    if is_vcf:
        chrom, pos, _id, ref, var = f[0], int(f[1]), f[2], f[3], f[4]
        fmt = f[8].split(":")
        tumor_fields = f[10].split(":")
        kv = dict(zip(fmt, tumor_fields))
        return dict(
            chrom=chrom, pos=pos, ref=ref, var=var,
            cns_qual=_num(kv.get("GQ")), snp_qual=_num(kv.get("VAQ")),
            map_qual=_num(kv.get("MQ")), rd_depth=_num(kv.get("DP")),
            tumor_gt=kv.get("GT"), normal_var=None,
            somatic_status=kv.get("SS"),
        )
    chrom, pos, ref, var, normal_var = f[0], int(f[1]), f[2], f[3], f[4]
    return dict(
        chrom=chrom, pos=pos, ref=ref, var=var,
        cns_qual=_num(f[6]), snp_qual=_num(f[7]), map_qual=_num(f[8]),
        rd_depth=_num(f[12]), tumor_gt=None, normal_var=normal_var,
        somatic_status=None,
    )


def _num(x):
    if x is None or x == ".":
        return 0
    return float(x)


def run(args) -> int:
    indel_sites = set()
    if args.indel_file:
        indel_sites = load_indel_filter(args.indel_file,
                                        args.min_indel_score)

    out_path = args.out_file or args.snp_file + ".SNPfilter"
    out_fh = open(out_path, "w")
    lq_fh = open(args.lq_output, "w") if args.lq_output else None

    snps: list[dict] = []
    last_chr = ""
    is_vcf = False

    def flush_window():
        for s in snps:
            if s["pass"]:
                out_fh.write(s["line"])
            elif lq_fh:
                lq_fh.write(s["line"])
        snps.clear()

    with open(args.snp_file) as fh:
        for raw in fh:
            if raw.startswith("##fileformat=VCF"):
                is_vcf = True
            if raw.startswith("#"):
                out_fh.write(raw)
                continue
            rec = parse_line(raw, is_vcf)
            line = raw if raw.endswith("\n") else raw + "\n"

            near_indel = any(
                (rec["chrom"], rp) in indel_sites
                for rp in range(rec["pos"] - args.indel_win_size,
                                rec["pos"] + args.indel_win_size + 1)
            )
            if near_indel:
                if lq_fh:
                    lq_fh.write(line)
                continue

            ok = (rec["map_qual"] >= args.min_mapping_quality
                  and args.min_read_depth <= rec["rd_depth"]
                  <= args.max_read_depth)
            if not (rec["cns_qual"] >= args.min_cns_qual
                    or rec["snp_qual"] >= args.min_snp_qual):
                ok = False
            if args.tumor_variant_only and (
                (rec["tumor_gt"] is not None and rec["tumor_gt"] == "0/0")
                or (rec["tumor_gt"] is None and rec["var"] == rec["ref"])
            ):
                ok = False
            if not args.include_loh and (
                (rec["somatic_status"] is not None
                 and rec["somatic_status"] == "3")
                or (rec["somatic_status"] is None
                    and is_loh(rec["var"], rec["normal_var"] or ""))
            ):
                ok = False
            if not ok:
                if lq_fh:
                    lq_fh.write(line)
                continue

            if rec["chrom"] != last_chr:
                flush_window()
                last_chr = rec["chrom"]

            snps.append({"line": line, "pos": rec["pos"], "pass": True})

            # density window (snpfilter.pl:185-198)
            if len(snps) == args.max_snp_per_win + 1:
                if snps[-1]["pos"] - snps[0]["pos"] < args.snp_win_size:
                    for s in snps:
                        s["pass"] = False
                first = snps.pop(0)
                if first["pass"]:
                    out_fh.write(first["line"])
                elif lq_fh:
                    lq_fh.write(first["line"])

    flush_window()
    out_fh.close()
    if lq_fh:
        lq_fh.close()
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
