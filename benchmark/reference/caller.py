"""The plain reference caller: BAM pair + FASTA -> VCF lines.

``call`` decodes both BAMs once, then scores the columns of the given
regions (all columns by default) in groups of at most ``group_bp``
positions, so memory stays bounded at genome scale.  A column is scored
only where the model can emit a record there: both samples hold a kept
(non-deleted) read, the reference base is not N, and the two samples
are not monomorphic for one and the same base with every kept read of
quality above 0 (then both consensus calls are that homozygote, and the
tool's ``tumor_base1 != normal_base1`` gate fails).  A CPU test holds
this shortcut to the full computation.

Besides the emitted lines, ``call`` returns the lines the tool would
write at columns that pass every gate but miss the ``-Q`` threshold by
no more than ``tol`` points: the fast contract lets a score move by one,
so such a column may rightly be emitted by a fast path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from . import model
from .bam import NT16, read_bam, read_fasta
from .pileup import entered_reads, entries, make_key, read_ends

REV = "=ACMGRSVTWYHKDBN"
# depth buckets the kept lanes are padded to
BUCKETS = (8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 256,
           384, 512, 1024, 4096, 1 << 16, 1 << 24)


@dataclass
class Result:
    lines: dict = field(default_factory=dict)   # key -> emitted line
    near: dict = field(default_factory=dict)    # key -> line at score Q-1
    columns: int = 0        # columns both samples share in the regions
    scored: int = 0         # columns the model was run on
    seconds: float = 0.0


def _masked(bases: int, values) -> str:
    out = [str(values[i]) for i in range(4) if bases & (1 << i)]
    return ",".join(out) if out else "0"


def _gt(ref: int, alts: int, gt: int) -> str:
    """output_vcf_gt (output_vcf.c:46-79)."""
    count = bin(gt & 0xF).count("1")
    parts, n_out = [], 0
    if gt & ref:
        if count == 1:
            return "0/0"
        parts.append("0")
        n_out += 1
    gt &= ~ref
    idx = 0
    for i in range(4):
        if alts & (1 << i):
            idx += 1
        if gt & (1 << i):
            if count == 1:
                return f"{idx}/{idx}"
            if n_out:
                parts.append("/")
            parts.append(str(idx))
            n_out += 1
    return "".join(parts)


def _sample(ref4, alts, gt, jgt, jq, cq, vaq, status, ssc, dq) -> str:
    g = _gt(ref4, alts, jgt) if jgt else _gt(ref4, alts, gt)
    ig = _gt(ref4, alts, gt)
    return (f"{g}:{ig}:{dq[16]}:{dq[12]},{dq[13]},{dq[14]},{dq[15]}:"
            f"{dq[8]},{dq[9]},{dq[10]},{dq[11]}:{cq}:"
            f"{jq if jgt else '.'}:{vaq}:{_masked(gt, dq[0:4])}:{dq[17]}:"
            f"{_masked(gt, dq[4:8])}:{status}:{ssc if ssc >= 0 else '.'}")


def vcf_line(name, pos, ref_char, ref4, t, n) -> str:
    """One VCF record (output_vcf.c:135-170): NORMAL before TUMOR.
    ``t`` / ``n``: (gt, jgt, jq, cq, vaq, status, ssc, dq row)."""
    alts = (t[0] | n[0]) & ~ref4
    alt = ",".join(REV[1 << i] for i in range(4) if alts & (1 << i)) or "."
    return (f"{name}\t{pos + 1}\t.\t{chr(ref_char)}\t{alt}\t.\t.\t.\t"
            "GT:IGT:DP:DP4:BCOUNT:GQ:JGQ:VAQ:BQ:MQ:AMQ:SS:SSC\t"
            f"{_sample(ref4, alts, *n)}\t{_sample(ref4, alts, *t)}\n")


def _groups(regions, group_bp):
    out, cur, size = [], [], 0
    for tid, beg, end in regions:
        while beg < end:
            take = min(end - beg, group_bp - size)
            cur.append((tid, beg, beg + take))
            size += take
            beg += take
            if size >= group_bp:
                out.append(cur)
                cur, size = [], 0
    if cur:
        out.append(cur)
    return out


def _columns(e, G):
    """Per position of the group (``G`` of them): raw depth, kept depth,
    and whether every kept entry is one base (its code, else 0) of
    quality above 0."""
    raw = np.bincount(e.col, minlength=G)
    kept = ~e.is_del
    ck = e.col[kept]
    n = np.bincount(ck, minlength=G)
    per_base = np.bincount(ck * 16 + e.base[kept], minlength=16 * G).reshape(G, 16)
    zero_q = np.bincount(ck[np.minimum(e.bq[kept], e.mq[kept]) == 0], minlength=G)
    mono = np.zeros(G, np.int64)
    for x in (1, 2, 4, 8):
        mono = np.where((per_base[:, x] == n) & (n > 0) & (zero_q == 0), x, mono)
    return raw, n, mono


def _lanes(e, rows_of, n):
    """Kept lanes of the scored columns (``rows_of``: position -> row, or
    -1) padded to depth buckets: yields (rows, [base, bq, mq, strand]
    [C, D]); ``n``: kept depth of each row."""
    row = rows_of[e.col]
    sel = np.flatnonzero((row >= 0) & ~e.is_del)
    row = row[sel]
    order = np.argsort(row, kind="stable")
    sel, row = sel[order], row[order]
    fields = [np.asarray(a)[sel].astype(np.int64)
              for a in (e.base, e.bq, e.mq, e.strand)]
    start = np.concatenate(([0], np.cumsum(n)))[:-1]
    within = np.arange(len(row)) - start[row]
    bucket = np.searchsorted(BUCKETS, n)
    for b in np.unique(bucket):
        rows = np.flatnonzero(bucket == b)
        D = int(max(1, n[rows].max()))
        slot = np.full(len(n), -1)
        slot[rows] = np.arange(len(rows))
        s = slot[row]
        ok = s >= 0
        out = []
        for f in fields:
            a = np.zeros((len(rows), D), np.int64)
            a[s[ok], within[ok]] = f[ok]
            out.append(a)
        yield rows, out


def _score_group(grp, ent_t, ent_n, refs, names, tab, p, precision,
                 res, tol, shortcut):
    lens = [end - beg for _, beg, end in grp]
    G = int(sum(lens))
    raw_t, n_t, mono_t = _columns(ent_t, G)
    raw_n, n_n, mono_n = _columns(ent_n, G)
    res.columns += int(((raw_t > 0) & (raw_n > 0)).sum())
    tids = np.repeat([g[0] for g in grp], lens)
    poss = np.concatenate([np.arange(beg, end) for _, beg, end in grp])
    chars = np.full(G, ord("N"), np.int64)
    for tid in np.unique(tids):
        seq = refs.get(names[tid])
        if seq is None:
            continue
        m = tids == tid
        arr = np.frombuffer(seq, np.uint8)
        pp = poss[m]
        chars[m] = np.where(pp < len(arr), arr[np.minimum(pp, len(arr) - 1)],
                            ord("N"))
    rb4_all = NT16[chars].astype(np.int64)
    skip = (mono_t > 0) & (mono_t == mono_n) & shortcut
    todo = np.flatnonzero((n_t > 0) & (n_n > 0) & (rb4_all != 15) & ~skip)
    res.scored += len(todo)
    if not len(todo):
        return
    rows_of = np.full(G, -1)
    rows_of[todo] = np.arange(len(todo))
    r4 = rb4_all[todo]
    nt, nn = n_t[todo], n_n[todo]
    lk, lanes = {}, {}
    for tag, ent, ncol in (("t", ent_t, nt), ("n", ent_n, nn)):
        lk[tag] = np.zeros((len(todo), 10), np.int64)
        lanes[tag] = []
        for rows, (b, bq, mq, st) in _lanes(ent, rows_of, ncol):
            lk[tag][rows] = model.glfgen(b, bq, mq, st, ncol[rows], r4[rows],
                                         tab, p.cap_mapq, precision)
            lanes[tag].append((rows, b, bq, mq, st))
    t1, t2, ts1, ts2 = model.glf2cns(lk["t"], raw_t[todo], tab.q_r)
    n1, n2, ns1, ns2 = model.glf2cns(lk["n"], raw_n[todo], tab.q_r)
    snp = (t1 != 15) & (n1 != 15) & (t1 != n1)
    t_vaq = np.minimum(np.where(t2 == r4, ts1, ts1 + ts2), 255)
    n_vaq = np.where((n1 != 15) & (n1 != r4),
                     np.minimum(np.where(n2 == r4, ns1, ns1 + ns2), 255), 0)
    score, jt, jn, jq = model.somatic_score(lk["t"], lk["n"], r4, tab, p.joint)
    t_eff = np.where(jt != 0, jt, t1)
    n_eff = np.where(jn != 0, jn, n1)
    loh = model.proper_subset(t_eff, n_eff)
    gor = ~model.proper_subset(r4, n_eff) & ((t_eff & ~n_eff) == r4)
    gates = snp & ~(p.no_loh & loh) & ~(p.no_gor & gor)
    emit = gates & (score >= p.min_qual)
    near = gates & (score < p.min_qual) & (score >= p.min_qual - tol)
    want = np.flatnonzero(emit | near)
    if not len(want):
        return
    t_st = np.where(t_eff == n_eff, model.GERMLINE,
                    np.where(loh, model.LOH,
                             np.where(score > 0, model.SOMATIC, model.UNKNOWN)))
    n_st = np.where(n1 == r4, model.WILDTYPE, model.GERMLINE)
    wanted = r4 | t_eff | n_eff
    dq = {}
    for tag, ncol in (("t", nt), ("n", nn)):
        dq[tag] = np.zeros((len(todo), 18), np.int64)
        for rows, b, bq, mq, st in lanes[tag]:
            sel = np.isin(rows, want)
            if sel.any():
                r = rows[sel]
                dq[tag][r] = model.dqstats(b[sel], bq[sel], mq[sel], st[sel],
                                           ncol[r], r4[r], wanted[r])
    for i in want.tolist():
        g = int(todo[i])
        t = (int(t1[i]), int(jt[i]), int(jq[i]), int(ts1[i]), int(t_vaq[i]),
             int(t_st[i]), int(score[i]), dq["t"][i].tolist())
        nrm = (int(n1[i]), int(jn[i]), int(jq[i]), int(ns1[i]), int(n_vaq[i]),
               int(n_st[i]), -1, dq["n"][i].tolist())
        line = vcf_line(names[tids[g]], int(poss[g]), int(chars[g]),
                        int(rb4_all[g]), t, nrm)
        key = (int(tids[g]) << 40) | int(poss[g])
        (res.lines if emit[i] else res.near)[key] = line


def call(tumor_bam, normal_bam, ref_fa, params: model.Params,
         regions=None, precision: str = "exact", group_bp: int = 1 << 20,
         reads=None, tol: int = 1, shortcut: bool = True) -> Result:
    """Score the pair over ``regions`` ((tid, beg, end), sorted, disjoint;
    every contig whole when None).  ``reads`` may pass both samples'
    decoded reads (``read_pair``) to skip the decode; ``near`` collects
    the lines of columns whose score lies below ``-Q`` by ``tol`` or
    less; ``shortcut=False`` scores the monomorphic columns too."""
    t0 = time.perf_counter()
    rt, rn, refs = reads if reads is not None else read_pair(
        tumor_bam, normal_bam, ref_fa)
    if regions is None:
        regions = [(t, 0, ln) for t, ln in enumerate(rt.ref_lengths)]
    tab = model.tables(params)
    ent = []
    for r in (rt, rn):
        ridx = entered_reads(r, params.flag_mask, params.mapq_min)
        ent.append((r, ridx, read_ends(r, ridx)))
    res = Result()
    for grp in _groups(regions, group_bp):
        beg = make_key([g[0] for g in grp], [g[1] for g in grp])
        end = make_key([g[0] for g in grp], [g[2] for g in grp])
        e_t = entries(*ent[0], beg, end)
        e_n = entries(*ent[1], beg, end)
        _score_group(grp, e_t, e_n, refs, rt.ref_names, tab, params,
                     precision, res, tol, shortcut)
    res.seconds = time.perf_counter() - t0
    return res


def read_pair(tumor_bam, normal_bam, ref_fa):
    return read_bam(tumor_bam), read_bam(normal_bam), read_fasta(ref_fa)
