"""Raw-DEFLATE streams for the card inflate's tests, each with the bytes
zlib inflates it to.

Every kind of stream RFC 1951 allows: stored, fixed-Huffman and
dynamic-Huffman blocks, a stream that mixes the three, empty and full
(65,536-byte) outputs, back-references at distances 1 and 32,768, codes
longer than a table lookup, zlib's levels 0, 1, 6 and 9 on BAM record
bytes, and BGZF blocks as they lie in a BAM file.
"""

from __future__ import annotations

import struct
import zlib
from bisect import bisect_right
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
            51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577]
DIST_EXTRA = [0, 0, 0, 0] + [k for k in range(1, 14) for _ in (0, 1)]
NAMES = ("stored", "fixed", "dynamic", "mixed", "empty", "empty_stored",
         "incompressible_65536", "run_distance_1", "distance_32768",
         "long_codes", "bam_level_0", "bam_level_1", "bam_level_6",
         "bam_level_9")


def raw_deflate(data: bytes, level: int = 6,
                strategy: int = zlib.Z_DEFAULT_STRATEGY,
                zdict: bytes | None = None,
                flush: int = zlib.Z_FINISH) -> bytes:
    kw = {"zdict": zdict} if zdict else {}
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy, **kw)
    return c.compress(data) + c.flush(flush)


def block_type(stream: bytes) -> int:
    """BTYPE of the stream's first block: 0 stored, 1 fixed, 2 dynamic."""
    return (stream[0] >> 1) & 3


def mixed_stream(a: bytes, b: bytes, c: bytes) -> bytes:
    """One stream of a stored block (``a``), a fixed-Huffman one (``b``,
    referring back into ``a``) and a dynamic one (``c``, referring back
    into both): each part ends byte-aligned (a sync flush) and the next
    starts with what came before as its dictionary."""
    s1 = raw_deflate(a, 0, flush=zlib.Z_SYNC_FLUSH)
    s2 = raw_deflate(b, 6, zlib.Z_FIXED, zdict=a, flush=zlib.Z_SYNC_FLUSH)
    s3 = raw_deflate(c, 6, zdict=(a + b)[-32768:])
    assert (block_type(s1), block_type(s2), block_type(s3)) == (0, 1, 2)
    return s1 + s2 + s3


class _Bits:
    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, v: int, n: int) -> None:
        self.acc |= v << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, c: int, n: int) -> None:
        """A Huffman code: its most significant bit first."""
        self.put(int(f"{c:0{n}b}"[::-1], 2), n)

    def done(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 0xFF)
        return bytes(self.out)


def _fixed_lit(bits: _Bits, sym: int) -> None:
    if sym < 144:
        bits.code(0x30 + sym, 8)
    elif sym < 256:
        bits.code(0x190 + sym - 144, 9)
    elif sym < 280:
        bits.code(sym - 256, 7)
    else:
        bits.code(0xC0 + sym - 280, 8)


def fixed_stream(tokens) -> bytes:
    """One final fixed-Huffman block of ``tokens``: an int is a literal
    byte, a pair (length, distance) a back-reference."""
    bits = _Bits()
    bits.put(1, 1)
    bits.put(1, 2)
    for t in tokens:
        if isinstance(t, int):
            _fixed_lit(bits, t)
            continue
        length, dist = t
        i = bisect_right(LEN_BASE, length) - 1
        _fixed_lit(bits, 257 + i)
        bits.put(length - LEN_BASE[i], LEN_EXTRA[i])
        j = bisect_right(DIST_BASE, dist) - 1
        bits.code(j, 5)
        bits.put(dist - DIST_BASE[j], DIST_EXTRA[j])
    _fixed_lit(bits, 256)
    return bits.done()


def bgzf_blocks(path) -> list[tuple[bytes, int, int]]:
    """(raw DEFLATE stream, ISIZE, CRC32) of every BGZF block of a file."""
    raw = Path(path).read_bytes()
    out, pos = [], 0
    while pos < len(raw):
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        bsize = struct.unpack_from("<H", raw, pos + 16)[0] + 1
        crc, isize = struct.unpack_from("<II", raw, pos + bsize - 8)
        out.append((raw[pos + 12 + xlen:pos + bsize - 8], isize, crc))
        pos += bsize
    return out


def bam_payload() -> bytes:
    """65,280 bytes of BAM records (the first full block of sim1's tumor)."""
    for stream, isize, _ in bgzf_blocks(DATA / "e2e" / "sim1" / "tumor.bam"):
        if isize == 0xFF00:
            return zlib.decompress(stream, -15)
    raise AssertionError("sim1's tumor BAM has no full block")


def cases() -> dict[str, tuple[bytes, bytes]]:
    """{name: (raw DEFLATE stream, what it inflates to)}."""
    rng = np.random.default_rng(16)
    bam = bam_payload()
    part = bam[:16384]
    noise = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    head = noise[:32768]
    # one byte dominant, a few hundred rare ones: codes up to 15 bits
    skew = np.zeros(60000, np.uint8)
    at = rng.choice(60000, 600, replace=False)
    skew[at] = rng.integers(1, 256, 600)
    skew = skew.tobytes() + bam[:5000]
    out = {
        "stored": (raw_deflate(part, 0), part),
        "fixed": (raw_deflate(part, 6, zlib.Z_FIXED), part),
        "dynamic": (raw_deflate(part, 6), part),
        "mixed": (mixed_stream(bam[:3000], bam[3000:9000], bam[9000:16384]),
                  bam[:16384]),
        "empty": (raw_deflate(b""), b""),
        "empty_stored": (raw_deflate(b"", 0), b""),
        "incompressible_65536": (raw_deflate(noise), noise),
        "run_distance_1": (raw_deflate(b"a" * 65536, 9), b"a" * 65536),
        "distance_32768": (
            fixed_stream(list(head) + [(258, 32768)] * 127 + [7, 9]),
            head + (head * 2)[:127 * 258] + bytes([7, 9])),
        "long_codes": (raw_deflate(skew, 9), skew),
    }
    for level in (0, 1, 6, 9):
        out[f"bam_level_{level}"] = (raw_deflate(bam, level), bam)
    assert tuple(out) == NAMES
    for name, (stream, data) in out.items():
        assert zlib.decompress(stream, -15) == data, name
    assert block_type(out["stored"][0]) == 0
    assert block_type(out["fixed"][0]) == 1
    assert block_type(out["dynamic"][0]) == 2
    return out


def zlib_inflate(stream: bytes, isize: int) -> bytes | None:
    """What the host loader makes of a block: the bytes, or None where
    zlib's raw inflate into ``isize`` bytes fails."""
    d = zlib.decompressobj(-15)
    try:
        got = d.decompress(stream, isize + 1)
    except zlib.error:
        return None
    return got if d.eof and len(got) == isize else None


def damaged(stream: bytes, n: int = 24, seed: int = 3):
    """``n`` copies of ``stream`` with one bit flipped, and its truncations
    at a few lengths."""
    rng = np.random.default_rng(seed)
    out = []
    for bit in rng.choice(len(stream) * 8, n, replace=False):
        b = bytearray(stream)
        b[bit // 8] ^= 1 << (bit % 8)
        out.append(bytes(b))
    for cut in (0, 1, 2, len(stream) // 3, len(stream) // 2,
                len(stream) - 2, len(stream) - 1):
        out.append(stream[:cut])
    return out
