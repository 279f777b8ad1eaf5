"""bam-readcount-compatible per-site allele metrics.

The reference's documented filtering workflow pipes sniper output through
the EXTERNAL ``bam-readcount`` binary between prepare_for_readcount and
fpfilter (reference gmt/documentation.md "Basic filtering", fpfilter.pl
field comment :173).  This module provides a compatible implementation so
the whole pipeline runs self-contained:

    chrom  pos(1-based)  ref  depth  =:...  A:...  C:...  G:...  T:...  N:...

with 14 ``:``-separated fields per base column, in fpfilter's expected
order (reference fpfilter.pl:173-175)::

    base : count : avg_mapping_quality : avg_basequality
         : avg_se_mapping_quality : num_plus_strand : num_minus_strand
         : avg_pos_as_fraction : avg_num_mismatches_as_fraction
         : avg_sum_mismatch_qualities : num_q2_containing_reads
         : avg_distance_to_q2_start_in_q2_reads : avg_clipped_length
         : avg_distance_to_effective_3p_end

Metric definitions (matching bam-readcount 0.4 semantics):

* positions are in soft-clip-adjusted read coordinates, oriented by
  strand (a reverse read's 5' end is its rightmost base);
* ``avg_pos_as_fraction`` — fractional distance of the base from the
  effective 5' end over the clipped length;
* ``avg_distance_to_effective_3p_end`` — fractional distance to the
  effective 3' end;
* mismatch metrics compare aligned M-op bases against the reference
  (``avg_sum_mismatch_qualities`` sums base qualities at mismatches);
* a "q2 run" is a trailing 3'-run of base quality exactly 2 (Illumina
  B-tail); the q2 distance is the mean absolute distance from the base
  to the run start among q2-containing reads;
* ``avg_se_mapping_quality`` is reported as the mapping quality (the
  original reads it from the SM aux tag when present; sniper's fpfilter
  never consumes this field).

Reads failing BAM_DEF_MASK flags, the mapping-quality threshold (``-q``),
or whose base at the site is below the base-quality threshold (``-b``)
are excluded, as in ``bam-readcount -q/-b``.

Copy of somatic_sniper_tpu/scripts/readcount.py: the port keeps its own
scripts and imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..constants import BAM_DEF_MASK
from ..io.bam import read_bam
from ..io.fasta import FastaFile

CMATCH, CINS, CDEL, CREF_SKIP, CSOFT, CHARD = 0, 1, 2, 3, 4, 5
NT16 = "=ACMGRSVTWYHKDBN"


class _ReadInfo:
    """Per-read derived data, computed once per read then reused for
    every site the read covers."""

    __slots__ = ("clip_start", "clipped_len", "reverse", "mm_frac",
                 "mmqs", "q2_start")

    def __init__(self, clip_start, clipped_len, reverse, mm_frac, mmqs,
                 q2_start):
        self.clip_start = clip_start
        self.clipped_len = clipped_len
        self.reverse = reverse
        self.mm_frac = mm_frac
        self.mmqs = mmqs
        self.q2_start = q2_start  # clipped coord of trailing q2 run, or -1


def _cigar_ops(reads, r):
    return [
        (int(c) & 0xF, int(c) >> 4)
        for c in reads.cigar[reads.cigar_off[r]:reads.cigar_off[r + 1]]
    ]


def _read_info(reads, r, refseq) -> _ReadInfo:
    ops = _cigar_ops(reads, r)
    s0 = int(reads.seq_off[r])
    l_qseq = int(reads.l_qseq[r])
    seq = reads.seq[s0 : s0 + l_qseq]
    qual = reads.qual[s0 : s0 + l_qseq]
    clip_start = ops[0][1] if ops and ops[0][0] in (CSOFT,) else 0
    clip_end = ops[-1][1] if ops and ops[-1][0] in (CSOFT,) else 0
    clipped_len = max(l_qseq - clip_start - clip_end, 0)
    reverse = bool(int(reads.flag[r]) & 0x10)

    # mismatch scan over M ops against the reference
    mm = 0
    mmqs = 0
    x = int(reads.pos[r])  # ref cursor
    y = 0                  # query cursor
    for op, ln in ops:
        if op == CMATCH:
            for i in range(ln):
                rx, qy = x + i, y + i
                if refseq is not None and rx < len(refseq):
                    rb = refseq[rx : rx + 1].upper()
                    qb = NT16[int(seq[qy]) & 0xF].encode()
                    if qb != b"=" and rb != qb and rb != b"N":
                        mm += 1
                        mmqs += int(qual[qy])
            x += ln
            y += ln
        elif op in (CINS, CSOFT):
            y += ln
        elif op in (CDEL, CREF_SKIP):
            x += ln

    # trailing 3' q2 run in sequencing orientation
    q2_start = -1
    if clipped_len > 0:
        cq = qual[clip_start : clip_start + clipped_len]
        if reverse:
            cq = cq[::-1]
        k = clipped_len
        while k > 0 and int(cq[k - 1]) == 2:
            k -= 1
        if k < clipped_len:
            q2_start = k

    mm_frac = mm / clipped_len if clipped_len else 0.0
    return _ReadInfo(clip_start, clipped_len, reverse, mm_frac, mmqs,
                     q2_start)


def _qpos_at(reads, r, site) -> int | None:
    """Query position of the aligned base at reference pos ``site``, or
    None when the read covers it with a deletion/skip or not at all."""
    x = int(reads.pos[r])
    y = 0
    for op, ln in _cigar_ops(reads, r):
        if op == CMATCH:
            if x <= site < x + ln:
                return y + (site - x)
            x += ln
            y += ln
        elif op in (CINS, CSOFT):
            y += ln
        elif op in (CDEL, CREF_SKIP):
            if x <= site < x + ln:
                return None
            x += ln
    return None


class _Acc:
    __slots__ = ("count", "mapq", "bq", "plus", "minus", "pos_frac",
                 "mm_frac", "mmqs", "q2", "q2_dist", "clip_len", "dist3")

    def __init__(self):
        self.count = 0
        self.mapq = 0.0
        self.bq = 0.0
        self.plus = 0
        self.minus = 0
        self.pos_frac = 0.0
        self.mm_frac = 0.0
        self.mmqs = 0.0
        self.q2 = 0
        self.q2_dist = 0.0
        self.clip_len = 0.0
        self.dist3 = 0.0

    def field(self) -> str:
        n = self.count
        if n == 0:
            return ("0:0.00:0.00:0.00:0:0:0.00:0.00:0.00:0:0.00:0.00:0.00")
        q2n = max(self.q2, 1)
        return (
            f"{n}:{self.mapq / n:.2f}:{self.bq / n:.2f}:{self.mapq / n:.2f}"
            f":{self.plus}:{self.minus}:{self.pos_frac / n:.2f}"
            f":{self.mm_frac / n:.2f}:{self.mmqs / n:.2f}:{self.q2}"
            f":{self.q2_dist / q2n:.2f}:{self.clip_len / n:.2f}"
            f":{self.dist3 / n:.2f}"
        )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="readcount",
        description="bam-readcount-compatible per-site allele metrics",
    )
    p.add_argument("-f", dest="ref", required=True,
                   help="indexed reference FASTA")
    p.add_argument("-l", dest="site_list", required=True,
                   help="site list (chrom\\tpos[\\tpos], 1-based; the "
                        "prepare_for_readcount output)")
    p.add_argument("-q", dest="min_mapq", type=int, default=0,
                   help="minimum mapping quality [0]")
    p.add_argument("-b", dest="min_baseq", type=int, default=0,
                   help="minimum base quality [0]")
    p.add_argument("bam")
    p.add_argument("out_file", nargs="?")
    return p


def run(args) -> int:
    fasta = FastaFile(args.ref)
    header, reads = read_bam(args.bam)
    name_to_tid = {n: i for i, n in enumerate(header.ref_names)}

    sites: list[tuple[int, int, str]] = []  # (tid, pos0, chrom)
    with open(args.site_list) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            # site lists may carry passed-through header lines (the
            # reference's prepare_for_readcount emits fields[0,1,1] for
            # EVERY input line, headers included) — skip anything that
            # is not a known contig with a numeric position
            if len(f) < 2 or f[0] not in name_to_tid or not f[1].isdigit():
                continue
            sites.append((name_to_tid[f[0]], int(f[1]) - 1, f[0]))
    sites.sort(key=lambda s: (s[0], s[1]))

    ends = np.zeros(reads.n, np.int64)
    for r in range(reads.n):
        x = int(reads.pos[r])
        for op, ln in _cigar_ops(reads, r):
            if op in (CMATCH, CDEL, CREF_SKIP):
                x += ln
        ends[r] = x
    mask = BAM_DEF_MASK
    keep = ((reads.flag & mask) == 0) & (reads.mapq >= args.min_mapq)

    refs: dict[int, bytes | None] = {}
    infos: dict[int, _ReadInfo] = {}
    out = open(args.out_file, "w") if args.out_file else sys.stdout
    try:
        for tid, pos0, chrom in sites:
            if tid not in refs:
                try:
                    refs[tid] = fasta.fetch(header.ref_names[tid])
                except Exception:
                    refs[tid] = None
            refseq = refs[tid]
            rb = (
                refseq[pos0 : pos0 + 1].decode().upper()
                if refseq is not None and pos0 < len(refseq) else "N"
            )
            acc = {b: _Acc() for b in "=ACGTN"}
            depth = 0
            cand = np.nonzero(
                keep & (reads.tid == tid) & (reads.pos <= pos0)
                & (ends > pos0)
            )[0]
            for r in cand:
                qpos = _qpos_at(reads, int(r), pos0)
                if qpos is None:
                    continue
                s0 = int(reads.seq_off[r])
                bq = int(reads.qual[s0 + qpos])
                if bq < args.min_baseq:
                    continue
                base = NT16[int(reads.seq[s0 + qpos]) & 0xF]
                if base not in acc:
                    base = "N"
                ri = infos.get(int(r))
                if ri is None:
                    ri = infos[int(r)] = _read_info(reads, int(r), refseq)
                depth += 1
                a = acc[base]
                a.count += 1
                a.mapq += int(reads.mapq[r])
                a.bq += bq
                rev = ri.reverse
                if rev:
                    a.minus += 1
                else:
                    a.plus += 1
                cl = max(ri.clipped_len, 1)
                qc = qpos - ri.clip_start  # clipped coords, left-based
                p5 = (cl - 1 - qc) if rev else qc  # distance from 5' end
                a.pos_frac += p5 / cl
                a.dist3 += (cl - 1 - p5) / cl
                a.mm_frac += ri.mm_frac
                a.mmqs += ri.mmqs
                a.clip_len += ri.clipped_len
                if ri.q2_start >= 0:
                    a.q2 += 1
                    a.q2_dist += abs(p5 - ri.q2_start)
            cols = "\t".join(
                f"{b}:{acc[b].field()}" for b in "=ACGTN"
            )
            out.write(f"{chrom}\t{pos0 + 1}\t{rb}\t{depth}\t{cols}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
