"""Synthetic tumor/normal read-pair simulator.

Generates deterministic sorted BAM pairs + reference FASTA for tests and
benchmarks: somatic/germline variants spiked at known sites, realistic
CIGAR structure (soft clips, insertions, deletions, ref skips), reads that
exercise the ingestion filters (dup/qcfail/secondary/unmapped/low mapq).

Copy of somatic_sniper_tpu/utils/simulate.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..constants import (
    BAM_FDUP,
    BAM_FQCFAIL,
    BAM_FREVERSE,
    BAM_FSECONDARY,
    BAM_FUNMAP,
)
from ..io.bam_writer import encode_record, write_bam

BASES = "ACGT"


@dataclass
class SimConfig:
    n_contigs: int = 2
    contig_len: int = 3000
    read_len: int = 75
    mean_depth: float = 25.0
    somatic_rate: float = 8e-3
    germline_rate: float = 4e-3
    indel_read_rate: float = 0.08
    clip_read_rate: float = 0.10
    skip_read_rate: float = 0.02
    filtered_read_rate: float = 0.03
    low_mapq_rate: float = 0.05
    baseq_lo: int = 15
    baseq_hi: int = 40
    error_rate: float = 0.005
    seed: int = 0


def _rand_cigar(rng, read_len, cfg):
    """Random CIGAR consuming exactly read_len query bases."""
    cigar = []
    remaining = read_len
    if rng.random() < cfg.clip_read_rate:
        c = int(rng.integers(1, 10))
        cigar.append((c, "S"))
        remaining -= c
    mid = []
    if rng.random() < cfg.indel_read_rate and remaining > 20:
        m1 = int(rng.integers(5, remaining - 10))
        if rng.random() < 0.5:
            ilen = int(rng.integers(1, 5))
            ilen = min(ilen, remaining - m1 - 5)
            if ilen > 0:
                mid = [(m1, "M"), (ilen, "I"), (remaining - m1 - ilen, "M")]
        else:
            dlen = int(rng.integers(1, 6))
            mid = [(m1, "M"), (dlen, "D"), (remaining - m1, "M")]
    elif rng.random() < cfg.skip_read_rate and remaining > 20:
        m1 = int(rng.integers(5, remaining - 10))
        nlen = int(rng.integers(10, 50))
        mid = [(m1, "M"), (nlen, "N"), (remaining - m1, "M")]
    if not mid:
        mid = [(remaining, "M")]
    cigar.extend(mid)
    if rng.random() < 0.05 and cigar[-1][1] == "M" and cigar[-1][0] > 5:
        last, _ = cigar.pop()
        c = int(rng.integers(1, 5))
        cigar.append((last - c, "M"))
        cigar.append((c, "S"))
    return cigar


def _apply_cigar(ref, pos, cigar, rng, error_rate, variants):
    """Build the query sequence for a read given reference + variant dict."""
    seq = []
    x = pos
    for length, op in cigar:
        if op == "M":
            for i in range(length):
                b = ref[x + i]
                v = variants.get(x + i)
                if v is not None and rng.random() < v[1]:
                    b = v[0]
                if rng.random() < error_rate:
                    b = BASES[int(rng.integers(4))]
                seq.append(b)
            x += length
        elif op in ("D", "N"):
            x += length
        elif op in ("I", "S"):
            seq.extend(BASES[int(rng.integers(4))] for _ in range(length))
    return "".join(seq)


def _ref_span(cigar):
    return sum(l for l, op in cigar if op in ("M", "D", "N"))


def simulate_pair(outdir: str | Path, cfg: SimConfig = SimConfig()):
    """Write ref.fa, tumor.bam, normal.bam (+ truth.tsv) into outdir."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)

    names = [f"ctg{i+1}" for i in range(cfg.n_contigs)]
    lengths = [cfg.contig_len] * cfg.n_contigs
    refs = {}
    fa_lines = []
    for nm in names:
        seq = "".join(BASES[i] for i in rng.integers(0, 4, cfg.contig_len))
        # sprinkle some N stretches
        if cfg.contig_len > 400:
            s = int(rng.integers(0, cfg.contig_len - 30))
            seq = seq[:s] + "N" * 20 + seq[s + 20 :]
        refs[nm] = seq
        fa_lines.append(f">{nm}")
        for i in range(0, len(seq), 60):
            fa_lines.append(seq[i : i + 60])
    (outdir / "ref.fa").write_text("\n".join(fa_lines) + "\n")

    # variant truth: germline shared, somatic tumor-only
    truth = []
    tumor_vars = [dict() for _ in names]
    normal_vars = [dict() for _ in names]
    for ci, nm in enumerate(names):
        for p in range(cfg.contig_len):
            r = refs[nm][p]
            if r == "N":
                continue
            u = rng.random()
            alt = BASES[(BASES.index(r) + 1 + int(rng.integers(3))) % 4]
            vaf = float(rng.choice([0.5, 1.0]))
            if u < cfg.somatic_rate:
                tumor_vars[ci][p] = (alt, vaf)
                truth.append((nm, p + 1, r, alt, f"somatic:{vaf}"))
            elif u < cfg.somatic_rate + cfg.germline_rate:
                tumor_vars[ci][p] = (alt, vaf)
                normal_vars[ci][p] = (alt, vaf)
                truth.append((nm, p + 1, r, alt, f"germline:{vaf}"))
    with open(outdir / "truth.tsv", "w") as f:
        for row in truth:
            f.write("\t".join(map(str, row)) + "\n")

    def make_reads(vars_by_contig, sample_seed):
        srng = np.random.default_rng(sample_seed)
        recs = []
        rid = 0
        for ci, nm in enumerate(names):
            n_reads = int(
                cfg.mean_depth * cfg.contig_len / cfg.read_len
            )
            starts = np.sort(
                srng.integers(0, cfg.contig_len - cfg.read_len, n_reads)
            )
            for pos in starts:
                pos = int(pos)
                cigar = _rand_cigar(srng, cfg.read_len, cfg)
                if _ref_span(cigar) + pos > cfg.contig_len:
                    cigar = [(cfg.read_len, "M")]
                    if pos + cfg.read_len > cfg.contig_len:
                        pos = cfg.contig_len - cfg.read_len
                seq = _apply_cigar(
                    refs[nm], pos, cigar, srng, cfg.error_rate,
                    vars_by_contig[ci],
                )
                qual = srng.integers(
                    cfg.baseq_lo, cfg.baseq_hi + 1, len(seq)
                ).astype(np.uint8)
                flag = 0
                if srng.random() < 0.5:
                    flag |= BAM_FREVERSE
                mapq = 60
                u = srng.random()
                if u < cfg.filtered_read_rate:
                    flag |= int(
                        srng.choice(
                            [BAM_FDUP, BAM_FQCFAIL, BAM_FSECONDARY,
                             BAM_FUNMAP]
                        )
                    )
                elif u < cfg.filtered_read_rate + cfg.low_mapq_rate:
                    mapq = int(srng.integers(0, 20))
                recs.append(
                    encode_record(
                        ci, pos, mapq, flag, seq, bytes(qual), cigar,
                        read_name=f"r{rid}",
                    )
                )
                rid += 1
        return recs

    write_bam(outdir / "tumor.bam", names, lengths,
              make_reads(tumor_vars, cfg.seed + 1))
    write_bam(outdir / "normal.bam", names, lengths,
              make_reads(normal_vars, cfg.seed + 2))
    return outdir


def simulate_pair_fast(outdir: str | Path, cfg: SimConfig = SimConfig()):
    """Vectorized megabase-scale pair generator (benchmarks only).

    Same output *shape* as :func:`simulate_pair` (ref.fa + sorted
    tumor/normal BAMs + truth.tsv) but generated with numpy batch ops —
    O(100x) faster, at the cost of simpler reads: pure read_len-M
    CIGARs, no clips/indels/skips/filtered reads.  NOT byte-compatible
    with simulate_pair for the same seed; existing fixtures and the
    recorded bench baseline stay on the original generator.
    """
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    names = [f"ctg{i+1}" for i in range(cfg.n_contigs)]
    lengths = [cfg.contig_len] * cfg.n_contigs
    L, R = cfg.contig_len, cfg.read_len

    base_arr = np.frombuffer(b"ACGT", np.uint8)
    refs_u8 = {}
    fa = []
    fai = []
    offset = 0
    for nm in names:
        r = base_arr[rng.integers(0, 4, L)]
        refs_u8[nm] = r
        fa.append(f">{nm}".encode())
        fa.extend(r[i : i + 60].tobytes() for i in range(0, L, 60))
        offset += len(nm) + 2  # ">" + name + "\n"
        fai.append(f"{nm}\t{L}\t{offset}\t60\t61")
        offset += L + (L + 59) // 60  # sequence bytes + newlines
    (outdir / "ref.fa").write_bytes(b"\n".join(fa) + b"\n")
    (outdir / "ref.fa.fai").write_text("\n".join(fai) + "\n")

    # vectorized variant truth
    truth_rows = []
    tumor_v = {}
    normal_v = {}
    for ci, nm in enumerate(names):
        u = rng.random(L)
        alt = base_arr[
            (np.searchsorted(base_arr, refs_u8[nm])  # ref index 0..3
             + 1 + rng.integers(0, 3, L)) % 4
        ]
        vaf = rng.choice([0.5, 1.0], L)
        som = u < cfg.somatic_rate
        germ = (~som) & (u < cfg.somatic_rate + cfg.germline_rate)
        tumor_v[ci] = (som | germ, alt, vaf)
        normal_v[ci] = (germ, alt, vaf)
        for p in np.nonzero(som | germ)[0]:
            kind = "somatic" if som[p] else "germline"
            truth_rows.append(
                f"{nm}\t{p+1}\t{chr(refs_u8[nm][p])}\t{chr(alt[p])}"
                f"\t{kind}:{vaf[p]}"
            )
    (outdir / "truth.tsv").write_text(
        "\n".join(truth_rows) + ("\n" if truth_rows else "")
    )

    from ..constants import NT16_TABLE
    from ..io.bam_writer import encode_records_fixed, write_bam_stream

    # read names stay fixed-width across the whole file: widen with the
    # total read count (9 digits overflow above 100M reads, i.e. beyond
    # ~330 Mb of genome at 30x; width is unchanged at the cached bench
    # sizes so their bytes are stable)
    n_per_contig = int(cfg.mean_depth * L / R)
    name_width = max(9, 1 + len(str(cfg.n_contigs * n_per_contig)))

    def make(sample_v, seed):
        # Chunked generator over reads: the monolithic [n, R]
        # temporaries (f64 random draws, int gpos) peaked at tens of GB
        # on WGS-scale contigs; 2M-read chunks streamed straight into
        # the BGZF writer keep the working set under ~1 GB.
        srng = np.random.default_rng(seed)
        rid0 = 0
        CHUNK = 2_000_000
        arange_r = np.arange(R, dtype=np.int32)
        for ci, nm in enumerate(names):
            n = n_per_contig
            starts = np.sort(srng.integers(0, L - R, n))
            ref = refs_u8[nm]
            vmask, valt, vvaf = sample_v[ci]
            vvaf32 = vvaf.astype(np.float32)
            for s0 in range(0, n, CHUNK):
                st = starts[s0 : s0 + CHUNK]
                m = len(st)
                gpos = st.astype(np.int32)[:, None] + arange_r[None, :]
                seq = ref[gpos].copy()
                hit = vmask[gpos] & (
                    srng.random((m, R), dtype=np.float32) < vvaf32[gpos]
                )
                seq[hit] = valt[gpos][hit]
                err = srng.random((m, R), dtype=np.float32) < cfg.error_rate
                seq[err] = base_arr[srng.integers(0, 4, int(err.sum()))]
                quals = srng.integers(
                    cfg.baseq_lo, cfg.baseq_hi + 1, (m, R)
                ).astype(np.uint8)
                flags = np.where(
                    srng.random(m) < 0.5, BAM_FREVERSE, 0
                ).astype(np.uint16)
                yield encode_records_fixed(
                    ci, st, np.full(m, 60, np.uint8), flags,
                    NT16_TABLE[seq], quals, R, name_width=name_width,
                    rid0=rid0,
                )
                rid0 += m

    # bench data: fastest BGZF level.  The two samples' read streams
    # are independent given the (already generated) variant truth, so
    # they generate in two forked processes — the record synthesis is
    # single-thread numpy-RNG-bound and dominates wall time at WGS
    # scale (identical RNG streams and bytes per sample either way).
    import multiprocessing as mp

    def _gen_one(sample_v, seed, path):
        write_bam_stream(path, names, lengths, make(sample_v, seed),
                         level=1)

    ctx = mp.get_context("fork")
    child = ctx.Process(
        target=_gen_one, args=(normal_v, cfg.seed + 2,
                               outdir / "normal.bam"),
    )
    child.start()
    _gen_one(tumor_v, cfg.seed + 1, outdir / "tumor.bam")
    child.join()
    if child.exitcode != 0:
        raise RuntimeError(
            f"normal.bam generation failed (exit {child.exitcode})"
        )
    return outdir
