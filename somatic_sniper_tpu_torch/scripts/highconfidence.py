"""High-confidence filter — port of the reference's highconfidence.pl.

Keeps sites whose tumor variant-allele mapping quality and somatic score
clear thresholds (reference highconfidence.pl:55-101; defaults minMQ 40,
min somatic score 40).

Copy of somatic_sniper_tpu/scripts/highconfidence.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="highconfidence",
        description="High confidence filtering for SomaticSniper output",
    )
    p.add_argument("--snp-file", required=True)
    p.add_argument("--lq-output")
    p.add_argument("--min-mapping-quality", type=int, default=40)
    p.add_argument("--min-somatic-score", type=int, default=40)
    p.add_argument("--out-file")
    return p


def _vcf_fields(fields):
    """highconfidence.pl:68-85: variant-allele AMQ values + SSC."""
    ref, alts, fmt, tumor_sample = (
        fields[3], fields[4], fields[8], fields[10]
    )
    kv = dict(zip(fmt.split(":"), tumor_sample.split(":")))
    alleles = [ref] + alts.split(",")
    gt_idx = {int(a) for a in kv["GT"].split("/") if a != "."}
    used = sorted(alleles[i] for i in gt_idx)
    amq = kv.get("AMQ", "").split(",")
    mapq_for_allele = dict(zip(used, amq))
    mapq_for_allele.pop(ref, None)
    mean_tumor_mapq = ",".join(v for v in mapq_for_allele.values())
    return mean_tumor_mapq, kv.get("SSC", ".")


def run(args) -> int:
    out_path = args.out_file or args.snp_file + ".hc"
    out = open(out_path, "w")
    lq = open(args.lq_output, "w") if args.lq_output else None

    is_vcf = False
    with open(args.snp_file) as fh:
        for raw in fh:
            if raw.startswith("##fileformat=VCF"):
                is_vcf = True
            if raw.startswith("#"):
                out.write(raw)
                continue
            line = raw.rstrip("\n")
            fields = line.split("\t")
            if is_vcf:
                mean_tumor_mapq, somatic_score = _vcf_fields(fields)
            else:
                mean_tumor_mapq, somatic_score = fields[18], fields[5]

            ok = any(
                float(q) >= args.min_mapping_quality
                for q in mean_tumor_mapq.split(",") if q not in ("", ".")
            )
            ok = ok and somatic_score not in ("", ".") and \
                float(somatic_score) >= args.min_somatic_score
            if ok:
                out.write(line + "\n")
            elif lq:
                lq.write(line + "\n")
    out.close()
    if lq:
        lq.close()
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
