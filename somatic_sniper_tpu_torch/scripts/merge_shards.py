"""Merge per-shard caller outputs into one file.

Multi-process runs (``--shards N --shard-index I``) each write their own
output file with its own header.  Shard windows are a contiguous genome
partition in shard order (parallel/sharded.shard_windows), so merging is
pure concatenation: the first file is copied whole and subsequent files
contribute only their record lines (leading ``#``/``track`` header lines
stripped).  The merged bytes equal a single-process run's output.

    python -m somatic_sniper_tpu_torch.scripts.merge_shards out.merged \\
        shard0.vcf shard1.vcf shard2.vcf

Copy of somatic_sniper_tpu/scripts/merge_shards.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys


def _is_header(line: str, first_line: bool) -> bool:
    return line.startswith("#") or (first_line and line.startswith("track"))


def merge(out_path: str, shard_paths: list[str]) -> None:
    with open(out_path, "w") as out:
        for i, path in enumerate(shard_paths):
            with open(path) as fh:
                first = True
                for line in fh:
                    if i > 0 and _is_header(line, first):
                        first = False
                        continue
                    first = False
                    out.write(line)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="merge_shards",
        description="Concatenate per-shard caller outputs (headers from "
                    "the first shard only)",
    )
    p.add_argument("out_file")
    p.add_argument("shards", nargs="+",
                   help="shard output files, in shard-index order")
    args = p.parse_args(argv)
    merge(args.out_file, args.shards)
    return 0


if __name__ == "__main__":
    sys.exit(main())
