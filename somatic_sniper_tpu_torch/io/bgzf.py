"""BGZF (block-gzip) container reader.

The BAM container format is BGZF: a sequence of independent gzip members of
at most 64 KiB uncompressed, each carrying a ``BC`` extra subfield with the
compressed block size (SAM spec §4.1; reference behaviour: vendor
``bgzf.c``).  Because members are independent, decompression parallelizes
per block — the native C++ reader (io/native) exploits that; this module is
the pure-Python fallback and also provides block-index scanning for
virtual-offset based region sharding.

Copy of somatic_sniper_tpu/io/bgzf.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def decompress_file(path: str | Path) -> bytes:
    """Decompress an entire BGZF file to bytes (multi-member gzip)."""
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw)


def scan_blocks(raw: bytes) -> np.ndarray:
    """Return [n_blocks, 2] array of (compressed_offset, compressed_size).

    Walks the BC extra subfields without inflating, enabling parallel
    block decompression and virtual-offset arithmetic.
    """
    offs = []
    pos = 0
    n = len(raw)
    while pos < n:
        if raw[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError(f"bad gzip magic at offset {pos}")
        xlen = struct.unpack_from("<H", raw, pos + 10)[0]
        extra = raw[pos + 12 : pos + 12 + xlen]
        bsize = None
        ep = 0
        while ep + 4 <= len(extra):
            si1, si2, slen = extra[ep], extra[ep + 1], struct.unpack_from("<H", extra, ep + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, ep + 4)[0] + 1
            ep += 4 + slen
        if bsize is None:
            raise ValueError(f"missing BC subfield at offset {pos} (not BGZF)")
        offs.append((pos, bsize))
        pos += bsize
    return np.array(offs, dtype=np.int64)


def decompress_blocks(raw: bytes, blocks: np.ndarray) -> bytes:
    """Inflate the given (offset, size) blocks and concatenate."""
    out = []
    for off, size in blocks:
        out.append(gzip.decompress(raw[off : off + size]))
    return b"".join(out)
