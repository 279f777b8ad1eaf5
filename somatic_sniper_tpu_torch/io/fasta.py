"""faidx-style indexed FASTA access (reference: vendor faidx.c).

Provides whole-contig fetch by name, which is all the caller needs (the
reference fetches one full contig per tid change, somatic_sniper.c:112-117).
Builds the ``.fai`` in memory when missing, with the same line-geometry
model as samtools faidx.

Copy of somatic_sniper_tpu/io/fasta.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


def _gunzip_all(raw: bytes) -> bytes:
    """Decompress every gzip member; tolerate trailing non-gzip bytes
    (a RAZF file ends with its random-access index after the stream)."""
    import zlib

    out = []
    pos = 0
    while pos + 2 <= len(raw) and raw[pos : pos + 2] == b"\x1f\x8b":
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(raw[pos:]))
        out.append(d.flush())
        consumed = len(raw) - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    line_bases: int
    line_width: int


class FastaFile:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        # mmap instead of slurping: a WGS reference is ~3 GB and only
        # the fetched contigs' pages ever need to be resident
        import mmap

        self._fh = open(self.path, "rb")
        magic = self._fh.read(2)
        self._fh.seek(0)
        if magic == b"\x1f\x8b":
            # razip/gzip-compressed FASTA (reference vendor razf.c,
            # consumed via faidx.c): a RAZF file is a gzip-conformant
            # deflate stream with a trailing random-access index after
            # the compressed data.  The .fai offsets refer to the
            # UNCOMPRESSED text either way, so full decompression (the
            # index and any trailing bytes ignored) restores exactly
            # the byte layout the index describes.  Legacy opt-in
            # format: held in memory, not mmapped.
            self._data = _gunzip_all(self._fh.read())
        else:
            try:
                self._data = mmap.mmap(
                    self._fh.fileno(), 0, access=mmap.ACCESS_READ
                )
            except ValueError:  # empty file: mmap cannot map length 0
                self._data = b""
        fai = Path(str(self.path) + ".fai")
        if fai.exists():
            self.index = self._parse_fai(fai.read_text(), fai)
        else:
            self.index = self._build_index()
            self._save_fai(fai)
        # bounded contig cache: callers fetch one contig at a time in
        # coordinate order (RefCache mirrors the reference's per-tid
        # cache); holding every fetched contig forever cost ~3 GB at
        # WGS scale
        self._cache: dict[str, bytes] = {}
        self._cache_max = 2

    @staticmethod
    def _parse_fai(text: str, path: Path | None = None) -> dict[str, FaiEntry]:
        """Parse a ``.fai``; on any malformed line raise ONE actionable
        error instead of crashing deep in a fetch.  The reference
        segfaults on a malformed index (documented in its install FAQ,
        reference gmt/install.md); a truncated transfer or a stray edit
        should tell the user what to do, not trace back."""
        idx: dict[str, FaiEntry] = {}
        for ln, line in enumerate(text.splitlines(), 1):
            if not line.strip():
                continue
            parts = line.split("\t")
            try:
                if len(parts) < 5:
                    raise ValueError("expected 5 tab-separated columns")
                e = FaiEntry(
                    name=parts[0],
                    length=int(parts[1]),
                    offset=int(parts[2]),
                    line_bases=int(parts[3]),
                    line_width=int(parts[4]),
                )
                if e.length < 0 or e.offset < 0 or e.line_bases <= 0 \
                        or e.line_width < e.line_bases:
                    raise ValueError("implausible geometry")
            except ValueError as err:
                where = str(path) if path is not None else ".fai"
                raise ValueError(
                    f"malformed FASTA index {where}, line {ln}: {line!r} "
                    f"({err}) — delete the .fai and rerun to rebuild it"
                ) from None
            idx[e.name] = e
        return idx

    def _save_fai(self, fai: Path) -> None:
        """Persist a freshly built index next to the FASTA (reference
        vendor faidx.c fai_build builds AND saves; building in memory
        only would re-scan the FASTA — minutes at WGS scale — in every
        process).  Offsets refer to the uncompressed text (samtools'
        convention for razf too).  Written atomically; an unwritable
        directory downgrades to the in-memory behavior silently."""
        try:
            tmp = fai.with_name(fai.name + f".tmp{os.getpid()}")
            tmp.write_text(
                "".join(
                    f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}"
                    f"\t{e.line_width}\n"
                    for e in self.index.values()
                )
            )
            tmp.replace(fai)
        except OSError:
            pass

    def _build_index(self) -> dict[str, FaiEntry]:
        idx: dict[str, FaiEntry] = {}
        data = self._data
        pos = 0
        n = len(data)
        while pos < n:
            if data[pos : pos + 1] != b">":
                raise ValueError("malformed FASTA (expected '>')")
            eol = data.find(b"\n", pos)
            name = data[pos + 1 : eol].split()[0].decode()
            seq_off = eol + 1
            length = 0
            line_bases = line_width = 0
            p = seq_off
            first = True
            while p < n and data[p : p + 1] != b">":
                eol2 = data.find(b"\n", p)
                if eol2 == -1:
                    eol2 = n
                lb = eol2 - p
                # tolerate \r\n
                if lb and data[eol2 - 1 : eol2] == b"\r":
                    lb -= 1
                if first and lb:
                    line_bases = lb
                    line_width = eol2 - p + 1
                    first = False
                length += lb
                p = eol2 + 1
            idx[name] = FaiEntry(name, length, seq_off,
                                 line_bases or 1, line_width or 2)
            pos = p
        return idx

    def fetch(self, name: str) -> bytes | None:
        """Whole-contig sequence bytes (case preserved), or None."""
        if name in self._cache:
            return self._cache[name]
        e = self.index.get(name)
        if e is None:
            return None
        full_lines = e.length // e.line_bases
        rem = e.length % e.line_bases
        span = full_lines * e.line_width + rem
        raw = self._data[e.offset : e.offset + span]
        seq = raw.replace(b"\n", b"").replace(b"\r", b"")[: e.length]
        while len(self._cache) >= self._cache_max:
            self._cache.pop(next(iter(self._cache)))
        self._cache[name] = seq
        return seq
