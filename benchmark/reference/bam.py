"""Plain BAM and FASTA reading for the reference caller.

A BGZF file is a chain of raw-deflate members; each is inflated with
zlib (in a thread pool: zlib releases the interpreter lock), the
records are walked once for their offsets, and every fixed field is
gathered with numpy.  Written from the SAM/BAM specification (section
4.2), independent of the program under test.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

# 4-bit IUB code of a character ('=' is 0, anything unknown is N = 15)
NT16 = np.full(256, 15, np.uint8)
for _i, _ch in enumerate("=ACMGRSVTWYHKDBN"):
    NT16[ord(_ch)] = _i
    NT16[ord(_ch.lower())] = _i


def inflate_bgzf(raw: bytes, threads: int = 8) -> bytes:
    """The uncompressed stream of a BGZF file."""
    spans = []
    pos, n = 0, len(raw)
    while pos < n:
        if raw[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at {pos}")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        ep, bsize = pos + 12, None
        while ep < pos + 12 + xlen:
            slen = struct.unpack_from("<H", raw, ep + 2)[0]
            if raw[ep:ep + 2] == b"BC":
                bsize = struct.unpack_from("<H", raw, ep + 4)[0] + 1
            ep += 4 + slen
        if bsize is None:
            raise ValueError(f"no BC subfield at {pos}")
        spans.append((pos + 12 + xlen, pos + bsize - 8))
        pos += bsize
    mv = memoryview(raw)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        parts = list(ex.map(lambda s: zlib.decompress(mv[s[0]:s[1]], -15),
                            spans, chunksize=256))
    return b"".join(parts)


@dataclass
class Reads:
    """Every alignment record of a BAM: fixed fields and CIGARs as flat
    arrays; bases and qualities are read on demand (``bases``)."""

    ref_names: list
    ref_lengths: list
    tid: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    flag: np.ndarray
    n_cigar: np.ndarray
    cigar_off: np.ndarray   # start of each record's runs in ``cigar``
    cigar: np.ndarray       # u32 runs (len << 4 | op)
    l_seq: np.ndarray
    seq_start: np.ndarray   # byte offset of each record's packed bases
    data: np.ndarray        # the uncompressed stream, u8

    def bases(self, ridx):
        """(offset of each read's first base, 4-bit codes, qualities) of
        the reads ``ridx``, concatenated."""
        ls = self.l_seq[ridx]
        within = _ragged(ls)
        ss = np.repeat(self.seq_start[ridx], ls)
        byte = self.data[ss + within // 2]
        seq = np.where(within % 2 == 0, byte >> 4, byte & 0xF).astype(np.uint8)
        qual = self.data[ss + (np.repeat(ls, ls) + 1) // 2 + within]
        return np.concatenate(([0], np.cumsum(ls)))[:-1], seq, qual


def _le(arr, offs, width, signed=False):
    v = np.zeros(len(offs), np.int64)
    for b in range(width):
        v |= arr[offs + b].astype(np.int64) << (8 * b)
    if signed:
        top = np.int64(1) << (8 * width - 1)
        v = np.where(v >= top, v - (top << 1), v)
    return v


def _ragged(lengths):
    """[0..l0-1, 0..l1-1, ...]"""
    lengths = np.asarray(lengths, np.int64)
    ends = np.cumsum(lengths)
    return np.arange(int(ends[-1]) if len(ends) else 0,
                     dtype=np.int64) - np.repeat(ends - lengths, lengths)


def read_bam(path) -> Reads:
    with open(path, "rb") as fh:
        data = inflate_bgzf(fh.read())
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM stream")
    (l_text,) = struct.unpack_from("<i", data, 4)
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p)
        names.append(data[p + 4:p + 3 + l_name].decode())
        (ln,) = struct.unpack_from("<i", data, p + 4 + l_name)
        lengths.append(ln)
        p += 8 + l_name
    offs = []
    unpack = struct.Struct("<i").unpack_from
    n = len(data)
    while p + 4 <= n:
        offs.append(p)
        p += 4 + unpack(data, p)[0]
    arr = np.frombuffer(data, np.uint8)
    o = np.asarray(offs, np.int64)
    l_name = arr[o + 12].astype(np.int64)
    n_cig = _le(arr, o + 16, 2)
    cig_start = o + 36 + l_name
    run_off = np.repeat(cig_start, n_cig) + 4 * _ragged(n_cig)
    return Reads(
        ref_names=names, ref_lengths=lengths,
        tid=_le(arr, o + 4, 4, True), pos=_le(arr, o + 8, 4, True),
        mapq=arr[o + 13].astype(np.int64), flag=_le(arr, o + 18, 2),
        n_cigar=n_cig,
        cigar_off=np.concatenate(([0], np.cumsum(n_cig)))[:-1],
        cigar=_le(arr, run_off, 4).astype(np.uint32),
        l_seq=_le(arr, o + 20, 4, True), seq_start=cig_start + 4 * n_cig,
        data=arr)


def read_fasta(path) -> dict:
    """Contig name -> sequence bytes (case kept) of a plain FASTA."""
    out, name, chunks = {}, None, []
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    out[name] = b"".join(chunks)
                name, chunks = line[1:].split()[0].decode(), []
            elif name is not None:
                chunks.append(line)
    if name is not None:
        out[name] = b"".join(chunks)
    return out
