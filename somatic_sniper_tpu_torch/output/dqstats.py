"""Per-site depth/quality statistics (reference dqstats.c:6-53).

Computed host-side, only for emitted sites (a tiny fraction of columns),
in exact float64 — so the device kernel never has to carry these wide
per-allele accumulators.

Copy of somatic_sniper_tpu/output/dqstats.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(slots=True, eq=False)
class DqStats:
    """Per-allele fields are length-4 sequences (lists or numpy rows —
    formatters only index and stringify them)."""

    mean_baseq: list = field(default_factory=lambda: [0, 0, 0, 0])
    mean_mapq: list = field(default_factory=lambda: [0, 0, 0, 0])
    base_occ: list = field(default_factory=lambda: [0, 0, 0, 0])
    dp4: list = field(default_factory=lambda: [0, 0, 0, 0])
    total_depth: int = 0
    total_mean_mapq: int = 0

    def __eq__(self, other):
        if not isinstance(other, DqStats):
            return NotImplemented
        return (
            list(self.mean_baseq) == list(other.mean_baseq)
            and list(self.mean_mapq) == list(other.mean_mapq)
            and list(self.base_occ) == list(other.base_occ)
            and list(self.dp4) == list(other.dp4)
            and self.total_depth == other.total_depth
            and self.total_mean_mapq == other.total_mean_mapq
        )


def _native_dqstats(pu, col_idx, rb4, wanted):
    """[K, 18] int32 rows from the native pileup_dqstats, or None when
    the pileup is not native-owned."""
    owner = getattr(pu, "owner", None)
    if owner is None or getattr(owner, "_ptr", None) is None:
        return None
    import ctypes

    lib = owner._lib
    K = len(col_idx)
    ci = np.ascontiguousarray(col_idx, np.int64)
    rb = np.ascontiguousarray(rb4, np.int32)
    wa = np.ascontiguousarray(wanted, np.int32)
    out = np.empty((K, 18), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pileup_dqstats(
        owner._ptr,
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), K,
        rb.ctypes.data_as(i32p), wa.ctypes.data_as(i32p),
        out.ctypes.data_as(i32p),
    )
    return out


def get_dqstats(base16, baseq, mapq, strand, is_del, ref_base4, wanted_bases):
    """Exact replication of get_dqstats (reference dqstats.c:6-53).

    Inputs are the per-entry arrays of one column.  Quirk preserved: a '='
    base (code 0) satisfies ``(base & value) == base`` for every value, so
    it increments all four base_occ counters.
    """
    d = DqStats()
    keep = ~np.asarray(is_del, bool)
    b = np.asarray(base16)[keep].astype(np.int64)
    bq = np.asarray(baseq)[keep].astype(np.int64)
    mq = np.asarray(mapq)[keep].astype(np.int64)
    st = np.asarray(strand)[keep].astype(np.int64)

    d.total_depth = int(len(b))
    tot_mapq = int(mq.sum())

    is_ref = b == ref_base4
    for s in (0, 1):
        d.dp4[s] = int((is_ref & (st == s)).sum())
        d.dp4[2 + s] = int((~is_ref & (st == s)).sum())

    sb = [0, 0, 0, 0]
    sm = [0, 0, 0, 0]
    for j in range(4):
        value = 1 << j
        m = (b & value) == b
        d.base_occ[j] = int(m.sum())
        if value & wanted_bases:
            sb[j] = int(bq[m].sum())
            sm[j] = int(mq[m].sum())

    for j in range(4):
        if d.base_occ[j] > 0:
            # C: uint32 = uint32_sum / (double)occ + .499 (truncates)
            d.mean_baseq[j] = int(sb[j] / float(d.base_occ[j]) + 0.499)
            d.mean_mapq[j] = int(sm[j] / float(d.base_occ[j]) + 0.499)

    if d.total_depth > 0:
        d.total_mean_mapq = int(tot_mapq / float(d.total_depth) + 0.499)
    return d


def get_dqstats_batch(pu, col_idx, rb4, wanted) -> list[DqStats]:
    """Vectorized get_dqstats over many columns of one ColumnarPileup.

    ``col_idx``: [K] column indices into ``pu``; ``rb4``/``wanted``: [K]
    per-column reference code and wanted-base mask.  Value-identical to
    calling :func:`get_dqstats` per column (same truncation semantics),
    but one native (or numpy) pass over the concatenated entries instead
    of K python loops — emitted-site formatting was a visible fraction
    of end-to-end runtime at WGS scale.
    """
    rows = get_dqstats_rows(pu, col_idx, rb4, wanted)
    # one bulk tolist(), then cheap python-list slicing per record
    # (numpy row views + int() per field were ~3x slower here)
    return [
        DqStats(
            mean_baseq=r[0:4],
            mean_mapq=r[4:8],
            base_occ=r[8:12],
            dp4=r[12:16],
            total_depth=r[16],
            total_mean_mapq=r[17],
        )
        for r in rows.tolist()
    ]


def rows_to_dqstats(rows: np.ndarray) -> list[DqStats]:
    """DqStats objects from precomputed [K, 18] rows (device-computed
    slab columns or host-widened deep/tail rows)."""
    return [
        DqStats(
            mean_baseq=r[0:4],
            mean_mapq=r[4:8],
            base_occ=r[8:12],
            dp4=r[12:16],
            total_depth=r[16],
            total_mean_mapq=r[17],
        )
        for r in np.asarray(rows).tolist()
    ]


def get_dqstats_rows(pu, col_idx, rb4, wanted) -> np.ndarray:
    """[K, 18] int rows: mean_baseq[4] | mean_mapq[4] | base_occ[4] |
    dp4[4] | total_depth | total_mean_mapq — the raw layout of the
    native ``pileup_dqstats``, shared by the object wrapper above and
    the bulk text-emission path (which never builds DqStats objects)."""
    col_idx = np.asarray(col_idx, np.int64)
    K = len(col_idx)
    if K == 0:
        return np.empty((0, 18), np.int64)
    native_rows = _native_dqstats(pu, col_idx, rb4, wanted)
    if native_rows is not None:
        return native_rows
    starts = pu.offsets[col_idx]
    counts = (pu.offsets[col_idx + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    ends = np.cumsum(counts)
    src = np.repeat(starts, counts) + (
        np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    )
    seg = np.repeat(np.arange(K, dtype=np.int64), counts)

    s = pu.slots[src].astype(np.uint32)
    keep = ((s >> 21) & 1) == 0
    seg = seg[keep]
    s = s[keep]
    b = ((s >> 16) & 0xF).astype(np.int64)
    bq = ((s >> 8) & 0xFF).astype(np.int64)
    mq = (s & 0xFF).astype(np.int64)
    st = ((s >> 20) & 1).astype(np.int64)

    def acc(mask, w=None):
        if w is None:
            return np.bincount(seg[mask], minlength=K).astype(np.int64)
        return np.bincount(seg[mask], weights=w[mask], minlength=K).astype(
            np.int64
        )

    depth = np.bincount(seg, minlength=K).astype(np.int64)
    tot_mapq = np.bincount(seg, weights=mq, minlength=K).astype(np.int64)

    rb_e = np.asarray(rb4, np.int64)[seg]
    is_ref = b == rb_e
    dp4 = np.stack(
        [
            acc(is_ref & (st == 0)),
            acc(is_ref & (st == 1)),
            acc(~is_ref & (st == 0)),
            acc(~is_ref & (st == 1)),
        ],
        axis=1,
    )

    wanted = np.asarray(wanted, np.int64)
    occ = np.empty((K, 4), np.int64)
    mean_bq = np.zeros((K, 4), np.int64)
    mean_mq = np.zeros((K, 4), np.int64)
    for j in range(4):
        v = 1 << j
        m = (b & v) == b
        occ[:, j] = acc(m)
        w = (wanted & v) != 0
        sb = acc(m, bq) * w
        sm = acc(m, mq) * w
        nz = occ[:, j] > 0
        o = np.maximum(occ[:, j], 1).astype(np.float64)
        mean_bq[:, j] = np.where(nz, (sb / o + 0.499).astype(np.int64), 0)
        mean_mq[:, j] = np.where(nz, (sm / o + 0.499).astype(np.int64), 0)

    tot_mean = np.where(
        depth > 0,
        (tot_mapq / np.maximum(depth, 1).astype(np.float64) + 0.499).astype(
            np.int64
        ),
        0,
    )

    return np.concatenate(
        [mean_bq, mean_mq, occ, dp4, depth[:, None], tot_mean[:, None]],
        axis=1,
    )
