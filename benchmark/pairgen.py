"""Tumor/normal pair generator of the benchmark, made from the seed.

A frozen copy of ``simulate_pair_fast`` (somatic_sniper_tpu_torch/utils/
simulate.py), with the record encoder and BGZF writer of
``io/bam_writer.py`` and the binning of ``io/bai.py``, changed in four
ways so that a 10 Mb pair is made in seconds and nothing of the program
is needed:
- the reads are made in chunks of ``CHUNK`` reads, each from its own
  seed sequence (seed, sample, contig, chunk), by a pool of spawned
  worker processes; the bytes depend on the seed alone, not on the
  number of workers;
- the variant rates, depth, read length and qualities come from the
  configuration file;
- the BAI is written from the record offsets the writer knows, with no
  second pass over the BAM;
- nothing is written but ref.fa, its .fai, the two BAMs and their BAIs,
  each synced to disk before ``generate`` returns.
Reads are ``read_len``M with mapping quality 60, half of them reversed:
none is dropped by ``-q 1`` or the default flag mask.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BS = 0xFF00             # uncompressed bytes per BGZF block
CHUNK = 250_000         # reads per worker task
FREVERSE = 0x10
EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
NT16_OF_ACGT = np.zeros(256, np.uint8)
for _c, _v in zip(b"ACGT", (1, 2, 4, 8)):
    NT16_OF_ACGT[_c] = _v
BASES = np.frombuffer(b"ACGT", np.uint8)
KEYS = ("n_contigs", "contig_len", "read_len", "tumor_depth", "normal_depth",
        "somatic_rate", "germline_rate", "error_rate", "baseq_lo", "baseq_hi")


@dataclass
class Pair:
    dir: Path
    tumor: Path
    normal: Path
    ref: Path
    n_reads: tuple        # (tumor, normal)
    genome_len: int
    somatic_sites: int
    germline_sites: int
    read_len: int
    shared: list          # per contig: bool, both samples cover the position
    somatic: list         # (contig index, position) of each planted somatic site

    @property
    def mean_depth(self) -> float:
        """Kept bases a position, the mean of the two samples (every read
        is kept)."""
        return sum(self.n_reads) * self.read_len / (2 * self.genome_len)

    def window_columns(self, window_size: int) -> list:
        """Positions both samples cover, per genome window in the order
        of the windowed driver (contig by contig, ``window_size`` long)."""
        out = []
        for sh in self.shared:
            for beg in range(0, len(sh), window_size):
                out.append(int(sh[beg:beg + window_size].sum()))
        return out


def _seed(seed: int, *path: int):
    return np.random.SeedSequence([int(seed) % (1 << 64), *path])


def _genome(cfg: dict, seed: int, ci: int):
    """(ref bases, variant mask tumor, mask normal, alt, vaf) of a contig."""
    L = cfg["contig_len"]
    rng = np.random.default_rng(_seed(seed, 0, ci))
    ref = BASES[rng.integers(0, 4, L)]
    u = rng.random(L)
    alt = BASES[(np.searchsorted(BASES, ref) + 1 + rng.integers(0, 3, L)) % 4]
    vaf = rng.choice(np.array([0.5, 1.0], np.float32), L)
    som = u < cfg["somatic_rate"]
    germ = ~som & (u < cfg["somatic_rate"] + cfg["germline_rate"])
    return ref, som | germ, germ, alt, vaf


_GENOME_CACHE: dict = {}


def _bgzf(data: bytes, level: int = 1):
    """BGZF blocks of ``data`` and their compressed sizes."""
    out, sizes = [], []
    for i in range(0, len(data), BS):
        payload = data[i:i + BS]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        blk = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
               + struct.pack("<HBBHH", 6, 66, 67, 2, len(comp) + 25)
               + comp + struct.pack("<II", zlib.crc32(payload), len(payload)))
        out.append(blk)
        sizes.append(len(blk))
    return b"".join(out), sizes


def _chunk(task):
    """Worker: encode and compress reads [a, b) of one sample's contig."""
    cfg, seed, sample, ci, chunk, starts, rid0, name_w = task
    key = (seed, ci, tuple(sorted(cfg.items())))
    if key not in _GENOME_CACHE:
        _GENOME_CACHE.clear()
        _GENOME_CACHE[key] = _genome(cfg, seed, ci)
    ref, vt, vn, alt, vaf = _GENOME_CACHE[key]
    vmask = vt if sample == 0 else vn
    R = cfg["read_len"]
    rng = np.random.default_rng(_seed(seed, 10 + sample, ci, chunk))
    m = len(starts)
    gpos = starts.astype(np.int64)[:, None] + np.arange(R)[None, :]
    seq = ref[gpos]
    hit = vmask[gpos] & (rng.random((m, R), dtype=np.float32) < vaf[gpos])
    seq[hit] = alt[gpos][hit]
    err = rng.random((m, R), dtype=np.float32) < cfg["error_rate"]
    seq[err] = BASES[rng.integers(0, 4, int(err.sum()))]
    qual = rng.integers(cfg["baseq_lo"], cfg["baseq_hi"] + 1, (m, R)).astype(np.uint8)
    flags = np.where(rng.random(m) < 0.5, FREVERSE, 0)
    recs = _encode(ci, starts, flags, NT16_OF_ACGT[seq], qual, R, name_w, rid0)
    comp, sizes = _bgzf(recs)
    return comp, sizes, len(recs)


def _encode(tid, pos, flag, codes, qual, R, name_w, rid0) -> bytes:
    """Fixed-layout BAM records (io/bam_writer.encode_records_fixed)."""
    n = len(pos)
    l_name = name_w + 1
    lp = (R + 1) // 2
    body = 32 + l_name + 4 + lp + R
    out = np.zeros((n, 4 + body), np.uint8)

    def i32(off, v):
        out[:, off:off + 4] = (np.asarray(v, np.int64)[:, None]
                               >> np.array([0, 8, 16, 24])).astype(np.uint8)

    i32(0, np.full(n, body))
    i32(4, np.full(n, tid))
    i32(8, pos)
    out[:, 12] = l_name
    out[:, 13] = 60
    out[:, 16] = 1
    out[:, 18] = np.asarray(flag) & 0xFF
    i32(20, np.full(n, R))
    i32(24, np.full(n, -1))
    i32(28, np.full(n, -1))
    names = "".join(f"r{rid0 + i:0{name_w - 1}d}\x00" for i in range(n))
    out[:, 36:36 + l_name] = np.frombuffer(names.encode(), np.uint8).reshape(n, l_name)
    c = 36 + l_name
    i32(c, np.full(n, R << 4))
    packed = np.zeros((n, lp), np.uint8)
    packed[:, :(R + 1) // 2] = codes[:, 0::2] << 4
    packed[:, :R // 2] |= codes[:, 1::2]
    out[:, c + 4:c + 4 + lp] = packed
    out[:, c + 4 + lp:] = qual
    return out.tobytes()


def _header(names, lengths) -> bytes:
    text = "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths)).encode()
    out = b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", len(names))
    for n, l in zip(names, lengths):
        nb = n.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    return out


def _reg2bin(beg, end):
    e = end - 1
    out = np.full(len(beg), -1, np.int64)
    for off, shift in ((4681, 14), (585, 17), (73, 20), (9, 23), (1, 26)):
        m = (out < 0) & ((beg >> shift) == (e >> shift))
        out[m] = off + (beg[m] >> shift)
    out[out < 0] = 0
    return out


def _bai(n_ref, tid, pos, end, voff, end_voff) -> bytes:
    """Standard BAI (SAM spec 5.2) of sorted records with known voffsets."""
    vend = np.append(voff[1:], end_voff)
    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    for r in range(n_ref):
        sel = np.flatnonzero(tid == r)
        if not len(sel):
            out.append(struct.pack("<ii", 0, 0))
            continue
        p, e, vo, ve = pos[sel], end[sel], voff[sel], vend[sel]
        b = _reg2bin(p, e)
        order = np.argsort(b, kind="stable")
        bs, gi = b[order], sel[order]
        new = np.ones(len(order), bool)
        new[1:] = (bs[1:] != bs[:-1]) | (gi[1:] != gi[:-1] + 1)
        st = np.flatnonzero(new)
        sp = np.append(st[1:], len(order))
        cb, ce, cbin = vo[order][st], ve[order][sp - 1], bs[st]
        ub, ufirst, ucount = np.unique(cbin, return_index=True, return_counts=True)
        out.append(struct.pack("<i", len(ub)))
        for k in range(len(ub)):
            s = ufirst[k]
            ch = np.stack([cb[s:s + ucount[k]], ce[s:s + ucount[k]]], 1)
            out.append(struct.pack("<Ii", int(ub[k]), len(ch)))
            out.append(ch.astype("<u8").tobytes())
        n_intv = (int(e.max()) >> 14) + 1
        lin = np.full(n_intv, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(lin, p >> 14, vo)
        np.minimum.at(lin, (e - 1) >> 14, vo)
        lin[lin == np.iinfo(np.int64).max] = -1
        last = 0
        for w in range(n_intv):   # empty windows take the one before
            if lin[w] < 0:
                lin[w] = last
            last = lin[w]
        out.append(struct.pack("<i", n_intv) + lin.astype("<u8").tobytes())
    return b"".join(out)


def _write(path: Path, data: bytes) -> None:
    """Write and sync, so that no write-back of the pair runs later."""
    with open(path, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())


def generate(outdir, cfg: dict, seed: int, workers: int = 0) -> Pair:
    """Write ref.fa(.fai), tumor.bam(.bai), normal.bam(.bai) to ``outdir``
    from ``seed``; ``cfg`` holds the keys of ``KEYS``."""
    cfg = {k: cfg[k] for k in KEYS}
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    nc, L, R = cfg["n_contigs"], cfg["contig_len"], cfg["read_len"]
    names = [f"ctg{i + 1}" for i in range(nc)]
    n_of = [int(cfg["tumor_depth"] * L / R), int(cfg["normal_depth"] * L / R)]
    name_w = max(9, 1 + len(str(nc * max(n_of))))
    fa, fai, off, som, germ = [], [], 0, [], 0
    for ci, nm in enumerate(names):
        ref, vt, vn, _, _ = _genome(cfg, seed, ci)
        som += [(ci, int(p)) for p in np.flatnonzero(vt & ~vn)]
        germ += int(vn.sum())
        fa.append(f">{nm}".encode())
        fa.extend(ref[i:i + 60].tobytes() for i in range(0, L, 60))
        off += len(nm) + 2
        fai.append(f"{nm}\t{L}\t{off}\t60\t61")
        off += L + (L + 59) // 60
    _write(out / "ref.fa", b"\n".join(fa) + b"\n")
    _write(out / "ref.fa.fai", ("\n".join(fai) + "\n").encode())
    tasks = []
    covered = [np.ones(L, bool) for _ in range(nc)]
    for sample in (0, 1):
        rid, n_per = 0, n_of[sample]
        for ci in range(nc):
            rng = np.random.default_rng(_seed(seed, 2 + sample, ci))
            starts = np.sort(rng.integers(0, L - R, n_per))
            cov = np.cumsum(np.bincount(starts, minlength=L + 1)
                            - np.bincount(starts + R, minlength=L + 1))[:L]
            covered[ci] &= cov > 0
            for k, a in enumerate(range(0, n_per, CHUNK)):
                tasks.append((cfg, seed, sample, ci, k, starts[a:a + CHUNK],
                              rid + a, name_w))
            rid += n_per
    workers = workers or max(1, min(8, (os.cpu_count() or 2) - 1))
    ctx = mp.get_context("spawn")
    with ctx.Pool(workers) as pool:
        results = pool.map(_chunk, tasks, chunksize=1)
    head, hsizes = _bgzf(_header(names, [L] * nc))
    i = 0
    for sample, path in ((0, out / "tumor.bam"), (1, out / "normal.bam")):
        coff, voffs, tids, poss = len(head), [], [], []
        n_per = n_of[sample]
        with open(path, "wb") as fh:
            fh.write(head)
            for ci in range(nc):
                for a in range(0, n_per, CHUNK):
                    comp, sizes, nbytes = results[i]
                    starts = tasks[i][5]
                    rec_len = nbytes // len(starts)
                    u = np.arange(len(starts), dtype=np.int64) * rec_len
                    bstart = coff + np.concatenate(([0], np.cumsum(sizes)))[:-1]
                    voffs.append((bstart[u // BS] << 16) | (u % BS))
                    tids.append(np.full(len(starts), ci))
                    poss.append(starts.astype(np.int64))
                    fh.write(comp)
                    coff += len(comp)
                    i += 1
            fh.write(EOF)
            fh.flush()
            os.fsync(fh.fileno())
        pos = np.concatenate(poss)
        bai = _bai(nc, np.concatenate(tids), pos, pos + R,
                   np.concatenate(voffs), coff << 16)
        _write(Path(str(path) + ".bai"), bai)
    return Pair(out, out / "tumor.bam", out / "normal.bam", out / "ref.fa",
                (n_of[0] * nc, n_of[1] * nc), L * nc, len(som), germ, R, covered,
                som)
