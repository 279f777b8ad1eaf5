"""False-positive filter using bam-readcount metrics.

Port of the reference's fpfilter.pl (VarScan2-style failure cascade,
thresholds :13-26, readcount join :92-108, cascade :209-285).  Writes
``<basename>.fp_pass`` / ``<basename>.fp_fail`` with the same appended
failure annotations and prints the same stats block.

Copy of somatic_sniper_tpu/scripts/fpfilter.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fpfilter",
        description="Advanced filtering for SomaticSniper output using "
                    "bam-readcount metrics",
    )
    p.add_argument("--snp-file", required=True)
    p.add_argument("--readcount-file", required=True)
    p.add_argument("--output-basename")
    p.add_argument("--verbose", default=0, type=int)
    p.add_argument("--min-read-pos", type=float, default=0.10)
    p.add_argument("--min-var-freq", type=float, default=0.05)
    p.add_argument("--min-var-count", type=float, default=4)
    p.add_argument("--min-strandedness", type=float, default=0.01)
    p.add_argument("--max-mm-qualsum-diff", type=float, default=50)
    p.add_argument("--max-mapqual-diff", type=float, default=30)
    p.add_argument("--max-readlen-diff", type=float, default=25)
    p.add_argument("--min-var-dist-3", type=float, default=0.20)
    p.add_argument("--max_var_mm_qualsum", type=float, default=100)
    return p


_IUPAC = {
    "M": {"A": "C", "C": "A"}, "R": {"A": "G", "G": "A"},
    "W": {"A": "T", "T": "A"}, "S": {"G": "C", "C": "G"},
    "Y": {"T": "C", "C": "T"}, "K": {"T": "G", "G": "T"},
}
_IUPAC_DEFAULT = {"M": "A", "R": "A", "W": "A", "S": "C", "Y": "C", "K": "G"}


def iupac_to_base(allele1: str, allele2: str) -> str:
    """fpfilter.pl:337-369."""
    if allele2 in "ACGT":
        return allele2
    if allele2 in _IUPAC:
        return _IUPAC[allele2].get(allele1, _IUPAC_DEFAULT[allele2])
    return allele2


def read_counts_by_allele(line: str, allele: str) -> list[str] | None:
    """fpfilter.pl:381-409: per-allele metric fields from a readcount line.

    Replicates a reference bug: the Perl joins fields with
    ``$s .= "\\t" if ($s)`` — when the first field is the string "0"
    (zero-count allele) the accumulator is falsy, so no tab is emitted and
    the first two fields merge (e.g. "0" + "47.64" -> "047.64"), shifting
    every later metric by one.  Downstream failure classifications depend
    on this, so we reproduce the join exactly.
    """
    cols = line.split("\t")
    for col in cols[5:]:
        parts = col.split(":")
        if parts[0] == allele:
            if len(parts) < 8:
                return None
            s = ""
            for v in parts[1:]:
                if _perl_true(s):
                    s += "\t"
                s += v
            return s.split("\t")
    return None


def _f(x: str) -> float:
    try:
        return float(x)
    except ValueError:
        return 0.0


def run(args) -> int:
    basename = args.output_basename or args.snp_file
    max_read_pos = 1 - args.min_read_pos  # kept for parity; unused (as in
    # the reference, whose read-pos upper check is commented out)
    max_strandedness = 1 - args.min_strandedness

    readcounts = {}
    with open(args.readcount_file) as fh:
        for line in fh:
            line = line.rstrip("\n")
            f = line.split("\t")
            if len(f) >= 2:
                readcounts[(f[0], f[1])] = line

    stats = {k: 0 for k in (
        "num_variants", "num_fail_pos", "num_fail_strand",
        "num_fail_varcount", "num_fail_varfreq", "num_fail_mmqs",
        "num_fail_var_mmqs", "num_fail_mapqual", "num_fail_readlen",
        "num_fail_dist3", "num_pass_filter", "num_no_readcounts",
    )}

    pass_fh = open(basename + ".fp_pass", "w")
    fail_fh = open(basename + ".fp_fail", "w")
    is_vcf = False

    with open(args.snp_file) as fh:
        for raw in fh:
            if raw.startswith("##fileformat=VCF"):
                is_vcf = True
            if raw.startswith("#"):
                pass_fh.write(raw)
                continue
            line = raw.rstrip("\n")
            fields = line.split("\t")
            if is_vcf:
                chrom, position, ref, alt = (
                    fields[0], fields[1], fields[3], fields[4]
                )
                fmt = fields[8].split(":")
                kv = dict(zip(fmt, fields[10].split(":")))
                alleles = [ref] + alt.split(",")
                gt_idx = {
                    int(a) for a in kv["GT"].split("/")
                    if a not in (".",) and int(a) > 0
                }
                used = sorted(alleles[i] for i in gt_idx)
                var = used[0] if used else ref
            else:
                chrom, position, ref, var = fields[0], fields[1], \
                    fields[2], fields[3]
            ref = ref.upper()
            var = var.upper()
            if var not in "ACGT" or len(var) != 1:
                var = iupac_to_base(ref, var)
            stats["num_variants"] += 1

            rc = readcounts.get((chrom, position))
            if not rc:
                stats["num_no_readcounts"] += 1
                fail_fh.write(f"{line}\tno_readcounts\n")
                continue
            ref_r = read_counts_by_allele(rc, ref)
            var_r = read_counts_by_allele(rc, var)
            if not (ref_r and var_r):
                stats["num_no_readcounts"] += 1
                fail_fh.write(f"{line}\tno_readcounts\n")
                continue

            # bam-readcount per-allele metric order (fpfilter.pl:172-175)
            ref_s = (ref_r + [""] * 13)[:13]
            var_s = (var_r + [""] * 13)[:13]
            (ref_count, ref_map_qual, _rbq, _rsemq, ref_plus, ref_minus,
             ref_pos, _rsubs, ref_mmqs, _rq2, _rq2d, ref_avg_rl,
             ref_dist_3) = map(_f, ref_s)
            (var_count, var_map_qual, _vbq, _vsemq, var_plus, var_minus,
             var_pos, _vsubs, var_mmqs, _vq2, _vq2d, var_avg_rl,
             var_dist_3) = map(_f, var_s)

            ref_strandedness = var_strandedness = 0.50
            # Perl string truthiness: "" and "0" are false, "0.0" is TRUE,
            # so the conservative defaults only apply to those strings
            # (fpfilter.pl:178-182).  Perl later interpolates the ORIGINAL
            # scalars into messages — strings verbatim, reassigned defaults
            # and computed diffs as %.15g numbers.
            ref_mmqs_s, var_mmqs_s = ref_s[8], var_s[8]
            if not _perl_true(ref_s[12]):
                ref_dist_3 = 0.5
            if not _perl_true(ref_s[8]):
                ref_mmqs = 50
                ref_mmqs_s = "50"
            if not _perl_true(var_s[8]):
                var_mmqs = 0
                var_mmqs_s = "0"
            mmqs_diff = var_mmqs - ref_mmqs
            mapqual_diff = ref_map_qual - var_map_qual
            readlen_diff = ref_avg_rl - var_avg_rl
            # Perl rounds through sprintf("%.2f") and later prints that
            # string; the 0.50 default is a number and prints as "0.5"
            ref_str_s, var_str_s = "0.5", "0.5"
            if ref_plus + ref_minus > 0:
                ref_str_s = f"{ref_plus / (ref_plus + ref_minus):.2f}"
                ref_strandedness = float(ref_str_s)
            if var_plus + var_minus > 0:
                var_str_s = f"{var_plus / (var_plus + var_minus):.2f}"
                var_strandedness = float(var_str_s)

            if not (var_count and (var_plus + var_minus)):
                continue  # reference silently skips these (fpfilter.pl:209)
            var_freq = var_count / (ref_count + var_count)
            prefix = (f"{line}\t{ref_s[6]}\t{var_s[6]}\t"
                      f"{ref_str_s}\t{var_str_s}")

            if var_pos < args.min_read_pos:
                fail_fh.write(
                    f"{prefix}\tReadPos<{_fmtnum(args.min_read_pos)}\n")
                stats["num_fail_pos"] += 1
            elif ((var_strandedness < args.min_strandedness
                   or var_strandedness > max_strandedness)
                  and (args.min_strandedness <= ref_strandedness
                       <= max_strandedness)):
                fail_fh.write(
                    f"{prefix}\tStrandedness: Ref={ref_str_s} "
                    f"Var={var_str_s}\n")
                stats["num_fail_strand"] += 1
            elif var_count < args.min_var_count:
                fail_fh.write(f"{prefix}\tVarCount:{var_s[0]}\n")
                stats["num_fail_varcount"] += 1
            elif var_freq < args.min_var_freq:
                fail_fh.write(f"{prefix}\tVarFreq:{_fmtnum(var_freq)}\n")
                stats["num_fail_varfreq"] += 1
            elif mmqs_diff > args.max_mm_qualsum_diff:
                fail_fh.write(
                    f"{prefix}\tMismatchQualsum:{var_mmqs_s}-"
                    f"{ref_mmqs_s}={_fmtnum(mmqs_diff)}\n")
                stats["num_fail_mmqs"] += 1
            elif mapqual_diff > args.max_mapqual_diff:
                fail_fh.write(
                    f"{prefix}\tMapQual:{ref_s[1]}-"
                    f"{var_s[1]}={_fmtnum(mapqual_diff)}\n")
                stats["num_fail_mapqual"] += 1
            elif readlen_diff > args.max_readlen_diff:
                fail_fh.write(
                    f"{prefix}\tReadLen:{ref_s[11]}-"
                    f"{var_s[11]}={_fmtnum(readlen_diff)}\n")
                stats["num_fail_readlen"] += 1
            elif var_dist_3 < args.min_var_dist_3:
                fail_fh.write(f"{prefix}\tVarDist3:{var_s[12]}\n")
                stats["num_fail_dist3"] += 1
            elif args.max_var_mm_qualsum and \
                    var_mmqs > args.max_var_mm_qualsum:
                fail_fh.write(
                    f"{prefix}\tVarMMQS: {var_mmqs_s} > "
                    f"{_fmtnum(args.max_var_mm_qualsum)}\n")
                stats["num_fail_var_mmqs"] += 1
            else:
                stats["num_pass_filter"] += 1
                pass_fh.write(line + "\n")

    pass_fh.close()
    fail_fh.close()

    print(f"{stats['num_variants']} variants")
    print(f"{stats['num_no_readcounts']} failed to get readcounts for "
          f"variant allele")
    print(f"{stats['num_fail_pos']} had read position < "
          f"{args.min_read_pos}")
    print(f"{stats['num_fail_strand']} had strandedness < "
          f"{args.min_strandedness}")
    print(f"{stats['num_fail_varcount']} had var_count < "
          f"{_fmtnum(args.min_var_count)}")
    print(f"{stats['num_fail_varfreq']} had var_freq < "
          f"{args.min_var_freq}")
    print(f"{stats['num_fail_mmqs']} had mismatch qualsum difference > "
          f"{_fmtnum(args.max_mm_qualsum_diff)}")
    if stats["num_fail_var_mmqs"]:
        print(f"{stats['num_fail_var_mmqs']} had variant MMQS > "
              f"{_fmtnum(args.max_var_mm_qualsum)}")
    print(f"{stats['num_fail_mapqual']} had mapping quality difference > "
          f"{_fmtnum(args.max_mapqual_diff)}")
    print(f"{stats['num_fail_readlen']} had read length difference > "
          f"{_fmtnum(args.max_readlen_diff)}")
    print(f"{stats['num_fail_dist3']} had var_distance_to_3' < "
          f"{args.min_var_dist_3}")
    print(f"{stats['num_pass_filter']} passed the strand filter")
    return 0


def _fmtnum(x: float) -> str:
    """Perl-style numeric stringification (%.15g)."""
    return f"{float(x):.15g}"


def _perl_true(s: str) -> bool:
    """Perl truthiness of a string scalar."""
    return s not in ("", "0")


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
