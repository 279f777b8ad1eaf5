"""Convert caller output to a bam-readcount -l site list.

Port of the reference's prepare_for_readcount.pl (:43-47): emits
``chrom\tpos\tpos`` for every record line.

Copy of somatic_sniper_tpu/scripts/prepare_for_readcount.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="prepare_for_readcount",
        description="Convert caller output to a position list for "
                    "bam-readcount's -l option",
    )
    p.add_argument("--snp-file", required=True)
    p.add_argument("--out-file")
    args = p.parse_args(argv)

    out_path = args.out_file or args.snp_file + ".pos"
    with open(args.snp_file) as fh, open(out_path, "w") as out:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            # the Perl emits fields[0,1,1] for every line, headers included
            # (missing fields print as empty strings, like Perl's undef)
            p1 = f[1] if len(f) > 1 else ""
            out.write(f"{f[0]}\t{p1}\t{p1}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
