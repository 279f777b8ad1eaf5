"""BAI (BAM index) build, parse, and region query.

The reference never uses an index (it streams whole files,
SURVEY.md §2.2), but region sharding in this framework requires random
access: each shard seeks to its genome interval instead of scanning the
whole BAM.  This module implements the standard UCSC-binning .bai format
(SAM spec §5.2 / samtools `bam_index.c` semantics):

* ``build_index`` — index a coordinate-sorted BAM (pure numpy over the
  BGZF block table; one-time cost per BAM, normally the .bai ships with
  the data).
* ``load_index`` / ``BaiIndex.write`` — binary .bai round-trip.
* ``region_chunks`` — merged virtual-offset chunk list covering all
  reads that may overlap [beg, end) of one reference.

Virtual offsets are ``coffset << 16 | uoffset`` per the spec.

Copy of somatic_sniper_tpu/io/bai.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .bgzf import scan_blocks

BAI_MAGIC = b"BAI\x01"
MAX_BIN = ((1 << 18) - 1) // 7  # 37449 bins, levels 0..5
LINEAR_SHIFT = 14  # 16 kb linear-index windows


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    """All bins that may contain reads overlapping [beg, end)."""
    end -= 1
    out = [0]
    for base, shift in ((1, 26), (9, 23), (73, 20), (585, 17), (4681, 14)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


@dataclass
class RefIndex:
    bins: dict = field(default_factory=dict)   # bin -> [n,2] i64 chunks
    linear: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint64)
    )


@dataclass
class BaiIndex:
    refs: list

    def write(self, path: str | Path) -> None:
        out = [BAI_MAGIC, struct.pack("<i", len(self.refs))]
        for r in self.refs:
            out.append(struct.pack("<i", len(r.bins)))
            for b in sorted(r.bins):
                chunks = np.asarray(r.bins[b], np.int64).reshape(-1, 2)
                out.append(struct.pack("<Ii", b, len(chunks)))
                out.append(chunks.astype("<u8").tobytes())
            out.append(struct.pack("<i", len(r.linear)))
            out.append(np.asarray(r.linear, "<u8").tobytes())
        Path(path).write_bytes(b"".join(out))


def load_index(path: str | Path) -> BaiIndex:
    data = Path(path).read_bytes()
    if data[:4] != BAI_MAGIC:
        raise ValueError(f"{path}: not a BAI file")
    pos = 4
    (n_ref,) = struct.unpack_from("<i", data, pos)
    pos += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, pos)
        pos += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, pos)
            pos += 8
            chunks = np.frombuffer(
                data, "<u8", count=2 * n_chunk, offset=pos
            ).astype(np.int64).reshape(-1, 2)
            pos += 16 * n_chunk
            bins[b] = chunks
        (n_intv,) = struct.unpack_from("<i", data, pos)
        pos += 4
        linear = np.frombuffer(data, "<u8", count=n_intv, offset=pos).copy()
        pos += 8 * n_intv
        refs.append(RefIndex(bins=bins, linear=linear))
    return BaiIndex(refs=refs)


def _record_table(raw: bytes):
    """(voffset i64[n], tid, pos, end) arrays for every alignment record.

    Decompresses block-by-block to map each record's uncompressed offset
    back to its BGZF virtual offset.
    """
    import gzip

    blocks = scan_blocks(raw)
    data = gzip.decompress(raw)
    # uncompressed start offset of each block
    usize = np.empty(len(blocks), np.int64)
    for i, (off, size) in enumerate(blocks):
        usize[i] = struct.unpack_from(
            "<I", raw, int(off) + int(size) - 4
        )[0]
    ustart = np.concatenate(([0], np.cumsum(usize)))[:-1]

    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    p = 4
    (l_text,) = struct.unpack_from("<i", data, p)
    p += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p)
        p += 4 + l_name + 4

    offs, tids, poss, ends = [], [], [], []
    n = len(data)
    while p + 4 <= n:
        (bs,) = struct.unpack_from("<i", data, p)
        offs.append(p)
        tid, pos = struct.unpack_from("<ii", data, p + 4)
        l_read_name = data[p + 12]
        n_cigar, _flag = struct.unpack_from("<HH", data, p + 16)
        cig = np.frombuffer(
            data, "<u4", count=n_cigar, offset=p + 4 + 32 + l_read_name
        )
        op = cig & 0xF
        span = int(cig[np.isin(op, (0, 2, 3, 7, 8))].__rshift__(4).sum())
        tids.append(tid)
        poss.append(pos)
        ends.append(pos + max(span, 1))
        p += 4 + bs
    offs = np.asarray(offs, np.int64)
    block_of = np.searchsorted(ustart, offs, side="right") - 1
    voff = (blocks[block_of, 0] << 16) | (offs - ustart[block_of])
    end_voff = (
        (blocks[-1, 0] + blocks[-1, 1]) << 16 if len(blocks) else 0
    )
    return (voff, np.asarray(tids, np.int32), np.asarray(poss, np.int64),
            np.asarray(ends, np.int64), n_ref, end_voff)


def _native_record_table(bam_path):
    """(voff, tid, pos, end, n_ref, end_voff) via the C layer, or None."""
    from . import native
    from .bam import read_bam_header

    lib = native.get_lib()
    if lib is None:
        return None
    rt = lib.bam_record_table(str(bam_path).encode(), 2)
    if not rt:
        raise IOError(
            f"{bam_path}: {lib.sniper_last_error().decode()}"
        )
    try:
        c = rt.contents
        n = int(c.n)
        if n:
            voff = np.ctypeslib.as_array(c.voff, shape=(n,)).copy()
            tid = np.ctypeslib.as_array(c.tid, shape=(n,)).copy()
            pos = np.ctypeslib.as_array(c.pos, shape=(n,)).copy()
            end = np.ctypeslib.as_array(c.end, shape=(n,)).copy()
        else:
            voff = np.zeros(0, np.int64)
            tid = np.zeros(0, np.int32)
            pos = np.zeros(0, np.int64)
            end = np.zeros(0, np.int64)
        end_voff = int(c.end_voff)
    finally:
        lib.rec_table_destroy(rt)
    n_ref = len(read_bam_header(str(bam_path)).ref_names)
    return voff, tid, pos, end, n_ref, end_voff


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized reg2bin (first matching level wins, like the scalar)."""
    e = end - 1
    out = np.full(len(beg), -1, np.int64)
    for off, shift in ((4681, 14), (585, 17), (73, 20), (9, 23), (1, 26)):
        m = (out < 0) & ((beg >> shift) == (e >> shift))
        out[m] = off + (beg[m] >> shift)
    out[out < 0] = 0
    return out


def build_index(bam_path: str | Path) -> BaiIndex:
    """Index a coordinate-sorted BAM (equivalent to `samtools index`).

    The record table comes from the native layer when available (a
    per-record Python decode dominated index builds at scale); binning,
    chunk coalescing, and the linear index are vectorized numpy.  The
    result is structurally identical to the original per-record builder
    (tested)."""
    t = _native_record_table(bam_path)
    if t is None:
        t = _record_table(Path(bam_path).read_bytes())
    voff, tid, pos, end, n_ref, end_voff = t
    voff = np.asarray(voff, np.int64)
    vend_all = np.concatenate([voff[1:], [end_voff]]) if len(voff) else voff
    refs = [RefIndex() for _ in range(n_ref)]
    for r in range(n_ref):
        sel = np.flatnonzero(tid == r)
        if len(sel) == 0:
            continue
        ri = refs[r]
        p_r = np.asarray(pos)[sel]
        e_r = np.asarray(end)[sel]
        vo = voff[sel]
        vend = vend_all[sel]
        b = _reg2bin_vec(p_r, e_r)
        # chunk coalescing: the original merges a record into the bin's
        # open chunk iff the previous record in that bin ended exactly
        # where this one starts — with strictly increasing voffsets that
        # is "globally consecutive record index"
        order = np.argsort(b, kind="stable")
        bs = b[order]
        gi = sel[order]
        new = np.empty(len(order), bool)
        new[0] = True
        new[1:] = (bs[1:] != bs[:-1]) | (gi[1:] != gi[:-1] + 1)
        starts = np.flatnonzero(new)
        stops = np.append(starts[1:], len(order))
        cbeg = vo[order][starts]
        cend = vend[order][stops - 1]
        cbins = bs[starts]
        bins: dict[int, list] = {}
        for k in range(len(starts)):
            bins.setdefault(int(cbins[k]), []).append(
                [int(cbeg[k]), int(cend[k])]
            )
        # linear index: min voffset per 16 kb window over covering reads
        max_end = int(e_r.max())
        n_intv = (max_end >> LINEAR_SHIFT) + 1
        linear = np.full(n_intv, -1, np.int64)
        w0 = p_r >> LINEAR_SHIFT
        w1 = (e_r - 1) >> LINEAR_SHIFT
        # voffsets increase with record order, so the first record
        # starting in a window holds its minimum
        uw, first = np.unique(w0, return_index=True)
        linear[uw] = vo[first]
        for i in np.flatnonzero(w1 > w0):  # rare: reads spanning windows
            for w in range(int(w0[i]) + 1, int(w1[i]) + 1):
                if linear[w] < 0 or vo[i] < linear[w]:
                    linear[w] = vo[i]
        covered = linear >= 0
        # fill gaps like samtools: empty windows inherit the previous one
        last = 0
        out_lin = np.zeros(n_intv, np.uint64)
        for w in range(n_intv):
            if covered[w]:
                last = int(linear[w])
            out_lin[w] = last
        ri.bins = {bk: np.asarray(c, np.int64) for bk, c in bins.items()}
        ri.linear = out_lin
    return BaiIndex(refs=refs)


def ensure_index(bam_path: str | Path) -> BaiIndex:
    """Load ``<bam>.bai`` if present and fresh, else build (and cache) it."""
    bam_path = Path(bam_path)
    bai = Path(str(bam_path) + ".bai")
    if bai.exists() and bai.stat().st_mtime >= bam_path.stat().st_mtime:
        return load_index(bai)
    idx = build_index(bam_path)
    try:
        idx.write(bai)
    except OSError:
        pass  # read-only data dir: keep the in-memory index
    return idx


def region_chunks(
    index: BaiIndex, tid: int, beg: int, end: int
) -> list[tuple[int, int]]:
    """Merged (vbeg, vend) chunk spans that cover all candidate reads
    overlapping [beg, end) of reference ``tid``."""
    if tid < 0 or tid >= len(index.refs):
        return []
    ri = index.refs[tid]
    min_voff = 0
    w = beg >> LINEAR_SHIFT
    if len(ri.linear):
        min_voff = int(ri.linear[min(w, len(ri.linear) - 1)])
    chunks = []
    for b in reg2bins(beg, end):
        c = ri.bins.get(b)
        if c is None:
            continue
        for vbeg, vend in np.asarray(c).reshape(-1, 2):
            if vend > min_voff:
                chunks.append((max(int(vbeg), min_voff), int(vend)))
    chunks.sort()
    merged: list[list[int]] = []
    for vb, ve in chunks:
        if merged and vb <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], ve)
        else:
            merged.append([vb, ve])
    return [(a, b) for a, b in merged]
