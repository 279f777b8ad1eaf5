"""BAM record decoding to columnar numpy arrays.

Replaces the reference's record-at-a-time ``bam_read1`` (vendor bam.c:181)
with a whole-buffer decode into struct-of-arrays form, ready for the
vectorized pileup columnarizer and for device transfer.  Field layout per
the SAM spec §4.2 (everything little-endian).

The record boundary scan is the only sequential part (each record's length
prefixes it); the C++ native reader (somatic_sniper_tpu/io/native) does the
same scan at memory bandwidth.  All field extraction is vectorized numpy.

Copy of somatic_sniper_tpu/io/bam.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..constants import BAM_FREVERSE
from .bgzf import decompress_file

BAM_MAGIC = b"BAM\x01"


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]

    def parse_rg_sample(self) -> str | None:
        """First @RG SM: field, if any (used for default sample naming)."""
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for field in line.split("\t"):
                    if field.startswith("SM:"):
                        return field[3:]
        return None

    def parse_rg(self) -> dict[str, str] | None:
        """@RG ID -> LB map, replicating samtools-0.1.6
        sam_header_parse_rg (vendored bam_import.c:173-227), which the
        reference driver calls on both headers (main.c:132,135) even
        though nothing downstream consumes the result.  Its quirks are
        kept: '@RG' is matched anywhere in the text (not just at line
        starts); the ID:/LB: values are found by plain substring search
        after it, even when that lands on a later line; a missing ID or
        LB tag aborts the whole scan; a pair commits only when the next
        '@RG' (or the end of text) is reached; returns None when no
        pair parsed."""
        text = self.text
        if len(text) < 3:
            return None
        out: dict[str, str] = {}
        rgid = rglib = ""

        def _value(start: int) -> tuple[str, int]:
            e = start
            while e < len(text) and text[e] not in "\t\r\n":
                e += 1
            return text[start:e], e

        s = 0
        while True:
            i = text.find("@RG", s)
            if i == -1:
                break
            if rgid and rglib:
                out[rgid] = rglib
            rgid = rglib = ""
            s = i + 3
            r = s
            p = text.find("ID:", s)
            if p == -1:
                print("[bam_header_parse] missing ID tag in @RG lines.",
                      file=sys.stderr)
                break
            rgid, e = _value(p + 3)
            r = max(r, e)
            p = text.find("LB:", s)
            if p == -1:
                print("[bam_header_parse] missing LB tag in @RG lines.",
                      file=sys.stderr)
                break
            rglib, e = _value(p + 3)
            r = max(r, e)
            s = r + 3
        if rgid and rglib:
            out[rgid] = rglib
        return out or None


class BamReads(NamedTuple):
    """Columnar read arrays (one entry per alignment record)."""

    tid: np.ndarray        # int32
    pos: np.ndarray        # int32 0-based leftmost
    flag: np.ndarray       # uint16
    mapq: np.ndarray       # uint8
    n_cigar: np.ndarray    # uint16
    l_qseq: np.ndarray     # int32
    cigar: np.ndarray      # uint32 flat
    cigar_off: np.ndarray  # int64 [n+1] offsets into cigar
    seq: np.ndarray        # uint8 flat, one 4-bit code per base (unpacked)
    qual: np.ndarray       # uint8 flat
    seq_off: np.ndarray    # int64 [n+1] offsets into seq/qual

    @property
    def n(self) -> int:
        return len(self.pos)

    def strand(self) -> np.ndarray:
        return ((self.flag & BAM_FREVERSE) != 0).astype(np.uint8)


def _ragged_indices(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat gather indices for per-record slices [starts[i], +lengths[i])."""
    total = int(lengths.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    flat = np.arange(total, dtype=np.int64)
    # subtract the start of each segment, add the record's byte offset
    seg_start = ends - lengths
    rep = np.repeat(np.arange(len(starts)), lengths)
    return flat - seg_start[rep] + starts[rep]


def decode_bam(data: bytes) -> tuple[BamHeader, BamReads]:
    """Decode an uncompressed BAM byte stream."""
    if data[:4] != BAM_MAGIC:
        raise ValueError("not a BAM file (bad magic)")
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8 : 8 + l_text].split(b"\x00")[0].decode()
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p)
        names.append(data[p + 4 : p + 4 + l_name - 1].decode())
        (l_ref,) = struct.unpack_from("<i", data, p + 4 + l_name)
        lengths.append(l_ref)
        p += 8 + l_name
    header = BamHeader(text=text, ref_names=names, ref_lengths=lengths)

    # --- record boundary scan (sequential by construction) ---
    offsets = []
    n = len(data)
    unpack_i = struct.Struct("<i").unpack_from
    while p + 4 <= n:
        (bs,) = unpack_i(data, p)
        offsets.append(p)
        p += 4 + bs
    if p != n:
        raise ValueError("truncated BAM record")
    offs = np.array(offsets, dtype=np.int64)

    buf = np.frombuffer(data, dtype=np.uint8)
    if len(offs) == 0:
        z = np.zeros(0, dtype=np.int64)
        return header, BamReads(
            tid=np.zeros(0, np.int32), pos=np.zeros(0, np.int32),
            flag=np.zeros(0, np.uint16), mapq=np.zeros(0, np.uint8),
            n_cigar=np.zeros(0, np.uint16), l_qseq=np.zeros(0, np.int32),
            cigar=np.zeros(0, np.uint32), cigar_off=np.zeros(1, np.int64),
            seq=np.zeros(0, np.uint8), qual=np.zeros(0, np.uint8),
            seq_off=np.zeros(1, np.int64),
        )

    def i32_at(off):
        return (
            buf[off].astype(np.int32)
            | (buf[off + 1].astype(np.int32) << 8)
            | (buf[off + 2].astype(np.int32) << 16)
            | (buf[off + 3].astype(np.int32) << 24)
        )

    def u16_at(off):
        return buf[off].astype(np.uint16) | (
            buf[off + 1].astype(np.uint16) << 8
        )

    tid = i32_at(offs + 4)
    pos = i32_at(offs + 8)
    l_read_name = buf[offs + 12].astype(np.int64)
    mapq = buf[offs + 13]
    n_cigar = u16_at(offs + 16)
    flag = u16_at(offs + 18)
    l_qseq = i32_at(offs + 20)

    cigar_start = offs + 36 + l_read_name
    cigar_len_b = n_cigar.astype(np.int64) * 4
    ci = _ragged_indices(cigar_start, cigar_len_b)
    cigar_bytes = buf[ci]
    cigar = cigar_bytes.view(np.uint8).reshape(-1, 4)
    cigar = (
        cigar[:, 0].astype(np.uint32)
        | (cigar[:, 1].astype(np.uint32) << 8)
        | (cigar[:, 2].astype(np.uint32) << 16)
        | (cigar[:, 3].astype(np.uint32) << 24)
    )
    cigar_off = np.zeros(len(offs) + 1, dtype=np.int64)
    np.cumsum(n_cigar.astype(np.int64), out=cigar_off[1:])

    seq_start = cigar_start + cigar_len_b
    seq_nbytes = (l_qseq.astype(np.int64) + 1) // 2
    si = _ragged_indices(seq_start, seq_nbytes)
    seq_packed = buf[si]
    # unpack 4-bit codes: high nibble first (vendor bam.h:204 bam1_seqi)
    hi = seq_packed >> 4
    lo = seq_packed & 0xF
    seq_pairs = np.empty((len(seq_packed), 2), dtype=np.uint8)
    seq_pairs[:, 0] = hi
    seq_pairs[:, 1] = lo
    # mask out the phantom low nibble of odd-length reads
    seq_off = np.zeros(len(offs) + 1, dtype=np.int64)
    np.cumsum(l_qseq.astype(np.int64), out=seq_off[1:])
    pair_off = np.zeros(len(offs) + 1, dtype=np.int64)
    np.cumsum(seq_nbytes * 2, out=pair_off[1:])
    flat_pairs = seq_pairs.reshape(-1)
    keep = np.ones(len(flat_pairs), dtype=bool)
    odd = (l_qseq % 2 == 1) & (l_qseq > 0)
    keep[pair_off[1:][odd] - 1] = False
    seq = flat_pairs[keep]

    qual_start = seq_start + seq_nbytes
    qi = _ragged_indices(qual_start, l_qseq.astype(np.int64))
    qual = buf[qi]

    return header, BamReads(
        tid=tid.astype(np.int32),
        pos=pos.astype(np.int32),
        flag=flag,
        mapq=mapq,
        n_cigar=n_cigar,
        l_qseq=l_qseq.astype(np.int32),
        cigar=cigar,
        cigar_off=cigar_off,
        seq=seq,
        qual=qual,
        seq_off=seq_off,
    )


def _iter_bgzf_inflated(fh):
    """Inflate BGZF blocks one at a time from an open file — reads only
    as many compressed bytes as consumed (the header parser needs the
    first block or two of a possibly-multi-GB file)."""
    import zlib

    while True:
        hdr = fh.read(12)
        if len(hdr) < 12:
            return
        if hdr[:2] != b"\x1f\x8b":
            raise ValueError("bad gzip magic (not BGZF)")
        xlen = int.from_bytes(hdr[10:12], "little")
        extra = fh.read(xlen)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            slen = int.from_bytes(extra[i + 2 : i + 4], "little")
            if extra[i] == 0x42 and extra[i + 1] == 0x43 and slen == 2:
                bsize = int.from_bytes(extra[i + 4 : i + 6], "little") + 1
            i += 4 + slen
        if bsize is None:
            raise ValueError("missing BC subfield (not BGZF)")
        rest = fh.read(bsize - 12 - xlen)
        if len(rest) < bsize - 12 - xlen:
            raise ValueError("truncated BGZF block")
        yield zlib.decompress(rest[:-8], -15)


def read_bam_header(path: str | Path) -> BamHeader:
    """Parse only the BAM header, streaming: inflates just enough
    leading BGZF blocks and never reads the rest of the file (the old
    implementation slurped the WHOLE BAM and scanned every block header
    — a 14.5 GB allocation and ~30 s per call on a WGS-scale input)."""
    import struct

    fh = open(Path(path), "rb")
    blocks = _iter_bgzf_inflated(fh)
    data = b""
    done = False

    def need(n):
        nonlocal data, done
        while len(data) < n and not done:
            try:
                data += next(blocks)
            except StopIteration:
                done = True
        if len(data) < n:
            fh.close()
            raise ValueError(f"{path}: truncated BAM header")

    need(12)
    if data[:4] != BAM_MAGIC:
        raise ValueError(f"{path}: not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    need(8 + l_text + 4)
    text = data[8 : 8 + l_text].split(b"\x00")[0].decode()
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    names, lengths = [], []
    for _ in range(n_ref):
        need(p + 4)
        (l_name,) = struct.unpack_from("<i", data, p)
        need(p + 8 + l_name)
        names.append(data[p + 4 : p + 4 + l_name - 1].decode())
        (ln,) = struct.unpack_from("<i", data, p + 4 + l_name)
        lengths.append(ln)
        p += 8 + l_name
    fh.close()
    return BamHeader(text=text, ref_names=names, ref_lengths=lengths)


def read_bam(path: str | Path) -> tuple[BamHeader, BamReads]:
    return decode_bam(decompress_file(path))
