"""Pileup columns of one sample, as SomaticSniper's pileup builds them.

Semantics (SomaticSniper's sniper_pileup.c on samtools 0.1.6):
- a read enters when ``flag & (UNMAP | mask)`` is 0 and ``mapq >= -q``;
- at each contig change, the first read that enters is dropped when its
  end lies at or before the start of the last read that entered on the
  contig before (the buffer position is not reset before the end check);
- M runs give a base at the aligned query position, D runs an entry
  marked deleted, N runs no entry; I and S consume query only; H, P,
  '=' and 'X' consume neither (samtools 0.1.6 knows no '=' or 'X').
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bam import Reads, _ragged

FUNMAP, FREVERSE = 0x4, 0x10
CMATCH, CINS, CDEL, CSKIP, CSOFT = 0, 1, 2, 3, 4


def make_key(tid, pos):
    return (np.asarray(tid, np.int64) << 40) | np.asarray(pos, np.int64)


@dataclass
class Entries:
    """One sample's pileup entries in a group of regions, unsorted:
    ``col`` is the entry's column as an index into the group's positions
    laid end to end (region by region)."""

    col: np.ndarray
    base: np.ndarray     # 4-bit code, 0 on deleted entries
    bq: np.ndarray
    mq: np.ndarray
    strand: np.ndarray   # 1 on the reverse strand
    is_del: np.ndarray   # bool


def _runs(reads: Reads, ridx):
    n_cig = reads.n_cigar[ridx]
    run_read = np.repeat(ridx, n_cig)
    flat = np.repeat(reads.cigar_off[ridx], n_cig) + _ragged(n_cig)
    runs = reads.cigar[flat]
    return run_read, (runs & 0xF).astype(np.int64), (runs >> 4).astype(np.int64)


def read_ends(reads: Reads, ridx):
    """pos + the M/D/N span of each read (bam_calend)."""
    run_read, op, ln = _runs(reads, ridx)
    span = np.where((op == CMATCH) | (op == CDEL) | (op == CSKIP), ln, 0)
    per = np.zeros(len(reads.pos), np.int64)
    np.add.at(per, run_read, span)
    return reads.pos[ridx] + per[ridx]


def entered_reads(reads: Reads, flag_mask: int, mapq_min: int):
    keep = ((reads.flag & (FUNMAP | flag_mask)) == 0) & (reads.mapq >= mapq_min)
    ridx = np.flatnonzero(keep)
    if len(ridx) < 2:
        return ridx
    tids = reads.tid[ridx]
    firsts = np.flatnonzero(tids[1:] != tids[:-1]) + 1
    if len(firsts):
        ends = read_ends(reads, ridx[firsts])
        drop = firsts[ends <= reads.pos[ridx[firsts - 1]]]
        ridx = np.delete(ridx, drop)
    return ridx


def entries(reads: Reads, ridx, ends, beg_keys, end_keys) -> Entries:
    """Entries of the entered reads ``ridx`` (with their ``ends``) that
    fall in the sorted, disjoint regions [beg_keys, end_keys)."""
    s_key = make_key(reads.tid[ridx], reads.pos[ridx])
    e_key = make_key(reads.tid[ridx], ends)
    i = np.searchsorted(end_keys, s_key, side="right")
    hit = (i < len(end_keys)) & (beg_keys[np.minimum(i, len(beg_keys) - 1)]
                                 < e_key)
    ridx = ridx[hit]
    seq_off, seq, qual = reads.bases(ridx)
    run_read, op, ln = _runs(reads, ridx)
    run_local = np.repeat(np.arange(len(ridx)), reads.n_cigar[ridx])
    ref_len = np.where((op == CMATCH) | (op == CDEL) | (op == CSKIP), ln, 0)
    q_len = np.where((op == CMATCH) | (op == CINS) | (op == CSOFT), ln, 0)
    first = np.ones(len(op), bool)
    first[1:] = run_read[1:] != run_read[:-1]

    def excl_cumsum(v):
        cs = np.cumsum(v)
        starts = np.flatnonzero(first)
        base = np.repeat(cs[starts] - v[starts],
                         np.diff(np.append(starts, len(v))))
        return cs - v - base

    x0 = make_key(reads.tid[run_read], reads.pos[run_read] + excl_cumsum(ref_len))
    y0 = excl_cumsum(q_len)
    sel = (op == CMATCH) | (op == CDEL)
    run_local, x0, y0, ln, is_d = (run_local[sel], x0[sel], y0[sel], ln[sel],
                                   op[sel] == CDEL)
    within = _ragged(ln)
    e_loc = np.repeat(run_local, ln)
    key = np.repeat(x0, ln) + within
    r = np.searchsorted(beg_keys, key, side="right") - 1
    rr = np.maximum(r, 0)
    m = (r >= 0) & (key < end_keys[rr])
    off = np.concatenate(([0], np.cumsum(end_keys - beg_keys)))[:-1]
    col = (off[rr] + key - beg_keys[rr])[m]
    e_loc = e_loc[m]
    e_del = np.repeat(is_d, ln)[m]
    qpos = (np.repeat(y0, ln) + within)[m]
    read = ridx[e_loc]
    qpos = np.minimum(qpos, np.maximum(reads.l_seq[read] - 1, 0))
    at = seq_off[e_loc] + qpos
    live = (~e_del).astype(np.uint8)
    return Entries(
        col=col,
        base=seq[at] * live,
        bq=qual[at] * live,
        mq=reads.mapq[read].astype(np.uint8),
        strand=((reads.flag[read] & FREVERSE) != 0).astype(np.uint8),
        is_del=e_del,
    )
