"""Minimal BAM writer (BGZF container + BAM records).

Used by the test-fixture simulator and benchmarks to synthesize sorted
tumor/normal BAM pairs; complements the reader in io/bam.py.

Copy of somatic_sniper_tpu/io/bam_writer.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

from ..constants import NT16_TABLE
from .bgzf import BGZF_EOF


def _bgzf_block(payload: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    # BC subfield stores (total block length - 1):
    # header(18) + comp + crc(4) + isize(4) - 1
    bsize = len(comp) + 25
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<HH", 2, bsize)
    )
    return (
        header
        + comp
        + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
        + struct.pack("<I", len(payload))
    )


def bgzf_compress(data: bytes, block_size: int = 0xFF00, level: int = 6,
                  threads: int = 1, eof: bool = True) -> bytes:
    """``eof=False`` omits the trailing empty EOF block so multiple
    compressed spans can be concatenated into one stream (BGZF members
    are independent; used by the streaming writer below)."""
    spans = range(0, len(data), block_size)
    if threads > 1 and len(data) > (8 << 20):
        # BGZF blocks are independent; zlib releases the GIL
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=threads) as ex:
            out = list(ex.map(
                lambda i: _bgzf_block(data[i : i + block_size], level),
                spans, chunksize=64,
            ))
    else:
        out = [_bgzf_block(data[i : i + block_size], level) for i in spans]
    if eof:
        out.append(BGZF_EOF)
    return b"".join(out)


_CIGAR_OPS = "MIDNSHP=X"


def encode_cigar(cigar: list[tuple[int, str]]) -> bytes:
    out = b""
    for length, op in cigar:
        out += struct.pack("<I", (length << 4) | _CIGAR_OPS.index(op))
    return out


def encode_record(
    tid: int,
    pos: int,
    mapq: int,
    flag: int,
    seq: str,
    qual: bytes,
    cigar: list[tuple[int, str]],
    read_name: str = "r",
    next_tid: int = -1,
    next_pos: int = -1,
    tlen: int = 0,
) -> bytes:
    name = read_name.encode() + b"\x00"
    n_cigar = len(cigar)
    l_seq = len(seq)
    # bin: legacy reg2bin — writers may set 0; readers here ignore it
    body = struct.pack(
        "<iiBBHHHiiii",
        tid,
        pos,
        len(name),
        mapq,
        0,
        n_cigar,
        flag,
        l_seq,
        next_tid,
        next_pos,
        tlen,
    )
    body += name + encode_cigar(cigar)
    packed = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(seq):
        code = int(NT16_TABLE[ord(ch)])
        packed[i // 2] |= code << (4 * (1 - i % 2))
    body += bytes(packed) + bytes(qual)
    return struct.pack("<i", len(body)) + body


def encode_records_fixed(
    tid: int,
    pos,
    mapq,
    flag,
    seq_codes,
    qual,
    read_len: int,
    name_width: int = 9,
    rid0: int = 0,
) -> bytes:
    """Vectorized encoder for n same-shaped records (single read_len-M
    CIGAR, fixed-width read names) — one numpy pass instead of n python
    encode_record calls.  ``seq_codes``: [n, read_len] uint8 nt16 codes;
    ``qual``: [n, read_len] uint8.  Returns the concatenated record
    bytes."""
    import numpy as np

    n = len(pos)
    l_name = name_width + 1  # +NUL
    l_packed = (read_len + 1) // 2
    body_len = 32 + l_name + 4 + l_packed + read_len
    rec_len = 4 + body_len
    out = np.zeros((n, rec_len), np.uint8)

    def put_i32(byte_off, values):
        out[:, byte_off : byte_off + 4] = (
            np.asarray(values, np.int64)[:, None]
            >> np.array([0, 8, 16, 24])[None, :]
        ).astype(np.uint8)

    put_i32(0, np.full(n, body_len))
    put_i32(4, np.full(n, tid))
    put_i32(8, pos)
    out[:, 12] = l_name
    out[:, 13] = np.asarray(mapq, np.uint8)
    # bin (2 bytes) stays 0
    out[:, 16] = 1  # n_cigar lo
    f = np.asarray(flag, np.uint16)
    out[:, 18] = (f & 0xFF).astype(np.uint8)
    out[:, 19] = (f >> 8).astype(np.uint8)
    put_i32(20, np.full(n, read_len))
    put_i32(24, np.full(n, -1))  # next_tid
    put_i32(28, np.full(n, -1))  # next_pos
    # tlen (32..35) stays 0
    if rid0 + n > 10 ** (name_width - 1):
        raise ValueError(
            f"read id {rid0 + n - 1} does not fit name_width="
            f"{name_width} (pass a wider name_width)"
        )
    names = np.frombuffer(
        "".join(f"r{rid0 + i:0{name_width - 1}d}\x00" for i in range(n))
        .encode(),
        np.uint8,
    ).reshape(n, l_name)
    out[:, 36 : 36 + l_name] = names
    cig_off = 36 + l_name
    put_i32(cig_off, np.full(n, (read_len << 4) | 0))  # read_lenM
    seq_off = cig_off + 4
    hi = seq_codes[:, 0::2]
    lo = seq_codes[:, 1::2]
    packed = np.zeros((n, l_packed), np.uint8)
    packed[:, : hi.shape[1]] = hi << 4
    packed[:, : lo.shape[1]] |= lo
    out[:, seq_off : seq_off + l_packed] = packed
    out[:, seq_off + l_packed :] = qual
    return out.tobytes()


def bam_header_bytes(ref_names: list[str], ref_lengths: list[int],
                     text: str | None = None) -> bytes:
    if text is None:
        text = "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths)
        )
    tb = text.encode()
    out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb
    out += struct.pack("<i", len(ref_names))
    for n, l in zip(ref_names, ref_lengths):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    return out


def write_bam_stream(
    path: str | Path,
    ref_names: list[str],
    ref_lengths: list[int],
    blob_iter,
    text: str | None = None,
    level: int = 6,
) -> None:
    """Streaming BAM writer: compresses and writes each record blob as
    it arrives instead of materializing the whole uncompressed stream
    (WGS-scale generation held tens of GB in RAM through write_bam).
    BGZF members are independent, so per-blob spans concatenate into
    one valid stream; a short carry keeps full-size blocks at blob
    boundaries."""
    with open(Path(path), "wb") as fh:
        fh.write(bgzf_compress(
            bam_header_bytes(ref_names, ref_lengths, text),
            level=level, eof=False,
        ))
        BS = 0xFF00
        carry = b""
        for blob in blob_iter:
            data = carry + blob
            cut = (len(data) // BS) * BS
            fh.write(bgzf_compress(data[:cut], level=level, eof=False))
            carry = data[cut:]
        fh.write(bgzf_compress(carry, level=level, eof=True))


def write_bam(
    path: str | Path,
    ref_names: list[str],
    ref_lengths: list[int],
    records: list[bytes] | bytes,
    text: str | None = None,
    level: int = 6,
    threads: int = 1,
) -> None:
    out = bam_header_bytes(ref_names, ref_lengths, text)
    out += records if isinstance(records, bytes) else b"".join(records)
    Path(path).write_bytes(bgzf_compress(out, level=level, threads=threads))
