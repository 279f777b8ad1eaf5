"""The card's region pileup build (``ops/csrc/pileup_build.cu``) and the
native loader's hand-off to it (``sniper_set_card_pileup``).

On every machine:
- the kernels' code, ``ops/csrc/pileup_build.cuh``, compiled for the host
  behind the card's C entry (``tests/pileup_warp_emul.cpp``: the scatter's
  warps as 32 fibers that switch at every ballot and shuffle) and
  registered with the native loader in the card's place: every region
  load's ukeys, offsets, slots and pure-reference flags byte-equal to the
  host build's, on the benchmark generator's pairs at 30x and 300x and on
  reads with every CIGAR operation, N skips, clips, a CIGAR past its
  sequence, windows that cut reads, a contig's carried quirk, and flags
  whose bound lies within a few ulps of the margin;
- the hand-off: one call a region, the counters, a region with a block
  the card refused built on the host, a declined call built on the host,
  a failed call failing its load, the whole-file load and a CPU run of
  the windowed driver never calling it.

Marked ``cuda`` (each skips without a card), on a machine with one:

    python -m pytest --noconftest -m cuda tests/test_torch_card_pileup.py
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from somatic_sniper_tpu_torch.constants import BAM_DEF_MASK  # noqa: E402
from somatic_sniper_tpu_torch.io import bai, native, native_api  # noqa: E402
from somatic_sniper_tpu_torch.io.bam import read_bam_header  # noqa: E402
from somatic_sniper_tpu_torch.io.bam_writer import (  # noqa: E402
    bam_header_bytes, encode_record, write_bam)
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables)
from somatic_sniper_tpu_torch.parallel.sharded import (  # noqa: E402
    call_pair_windows, genome_windows)
from somatic_sniper_tpu_torch.pileup.prefilter import (  # noqa: E402
    build_ref16, prefilter_tables)

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
CSRC = REPO / "somatic_sniper_tpu_torch" / "ops" / "csrc"
FIELDS = ("ukeys", "offsets", "slots", "pure")

CARD_FN = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p)
RELEASE_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("needs the native host library (g++ and zlib)")
    return lib


def _counts():
    return {k.split(".", 1)[1]: v
            for k, v in native.load_counters(_lib())[1].items()}


def _delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


@contextlib.contextmanager
def builder(addresses, inflater=None):
    """The card builder at ``addresses`` (and an inflater) registered for
    the block."""
    native.set_card_pileup(addresses)
    if inflater is not None:
        native.set_card_inflate(inflater, 0)
    try:
        yield
    finally:
        native.set_card_pileup(None)
        native.set_card_inflate(None)


# -- inputs --------------------------------------------------------------

def _flag_args(ref_path, header, margin=None):
    """(ref16 blob, offsets, fk, gmin, margin) as the windowed driver
    passes them, from the FASTA at ``ref_path``."""
    from somatic_sniper_tpu_torch.io.fasta import FastaFile
    from somatic_sniper_tpu_torch.runner import _ref_blob

    blob, off = _ref_blob(FastaFile(str(ref_path)), header)
    tabs = build_tables(ModelParams())
    gmin, m = prefilter_tables(tabs)
    return blob, off, tabs.fk, gmin, m if margin is None else margin


def _pairgen(tmp_path_factory, name, depth, contig_len, n_contigs=2,
             workers=1):
    sys.path.insert(0, str(REPO / "benchmark"))
    import pairgen

    cfg = {"n_contigs": n_contigs, "contig_len": contig_len, "read_len": 150,
           "tumor_depth": depth, "normal_depth": depth, "somatic_rate": 1e-3,
           "germline_rate": 1e-2, "error_rate": 0.005, "baseq_lo": 2,
           "baseq_hi": 41}
    return pairgen.generate(tmp_path_factory.mktemp(name), cfg, 2**31 + 19,
                            workers=workers)


@pytest.fixture(scope="module")
def pair30(tmp_path_factory):
    return _pairgen(tmp_path_factory, "pair30", 30.0, 40_000)


@pytest.fixture(scope="module")
def pair300(tmp_path_factory):
    return _pairgen(tmp_path_factory, "pair300", 300.0, 2_500)


EDGE_LEN = (3000, 2400)


def _edge_reads(rng, ref, tid):
    """Sorted records of contig ``tid`` drawn to reach every branch of the
    build: each CIGAR operation (N skips, D, I, S and H clips, P, = and
    X), a CIGAR that runs past its sequence, an empty sequence, reads the
    filters drop, and the reference's bases with a few errors."""
    ops = "MIDNSHP=X"
    out = []
    L = len(ref)
    pos = np.sort(rng.integers(0, L - 40, 420))
    for k, p in enumerate(pos):
        cigar = []
        if rng.random() < 0.3:
            cigar.append((int(rng.integers(1, 12)), "S"))
        if rng.random() < 0.1:
            cigar.insert(0, (int(rng.integers(1, 5)), "H"))
        for _ in range(int(rng.integers(1, 5))):
            op = ops[int(rng.choice(9, p=[.5, .08, .1, .06, .02, .02, .02,
                                            .1, .1]))]
            n = int(rng.integers(1, 400 if op == "N" else 60))
            cigar.append((n, op))
        cigar.append((int(rng.integers(1, 50)), "M"))
        if rng.random() < 0.3:
            cigar.append((int(rng.integers(1, 12)), "S"))
        qlen = sum(n for n, op in cigar if op in "MIS=X")
        short = rng.random()
        if short < 0.05 and 0 < k < len(pos) - 1:
            qlen = 0  # no sequence: every base read at position 0
        elif short < 0.15:
            qlen = max(1, qlen - int(rng.integers(1, 30)))
        seq = []
        x = int(p)
        for n, op in cigar:
            if op in "M=X":
                seq.extend(ref[x:x + n])
            elif op in "IS":
                seq.extend("ACGTN"[int(rng.integers(0, 5))] for _ in range(n))
            if op in "MDN":
                x += n
        seq = (seq + ["A"] * qlen)[:qlen]
        seq = ["ACGT"[int(rng.integers(0, 4))] if rng.random() < 0.03 else b
               for b in seq]
        qual = bytes(rng.integers(0, 42, qlen).astype(np.uint8))
        flag = int(rng.choice([0, 16, 0, 16, 0x4, 0x400, 0x200, 16 | 0x100]))
        mapq = int(rng.choice([0, 5, 19, 20, 37, 60, 60, 60, 255]))
        out.append(encode_record(tid, int(p), mapq, flag, "".join(seq),
                                 qual, cigar, read_name=f"r{tid}_{k}"))
    return out


@pytest.fixture(scope="module")
def edge(tmp_path_factory):
    """(bam, header, flag args): two contigs of reads from _edge_reads,
    and a reference that covers only the first 2,500 bases of the first
    contig (positions past it, and the second contig, are never pure),
    with N and '=' codes among its bases."""
    d = tmp_path_factory.mktemp("edge")
    rng = np.random.default_rng(23)
    refs = ["".join("ACGT"[i] for i in rng.integers(0, 4, n))
            for n in EDGE_LEN]
    recs = [r for tid, ref in enumerate(refs)
            for r in _edge_reads(rng, ref, tid)]
    bam = d / "edge.bam"
    write_bam(bam, ["e1", "e2"], list(EDGE_LEN), recs, level=1)
    bai.ensure_index(str(bam))
    r1 = bytearray(refs[0][:2500].encode())
    for i in rng.integers(0, 2500, 40):
        r1[int(i)] = ord("N")
    for i in rng.integers(0, 2500, 10):
        r1[int(i)] = ord("=")
    blob, off = build_ref16([bytes(r1)])
    tabs = build_tables(ModelParams())
    gmin, margin = prefilter_tables(tabs)
    return bam, read_bam_header(str(bam)), (blob, off, tabs.fk, gmin, margin)


def _load(bam, tid, beg, end, flag_args=None, drop=-1, mapq=0):
    """One region load as the windowed driver makes it: its arrays copied
    out of the native memory, or the error it raised."""
    idx = bai.ensure_index(str(bam))
    ch = np.asarray(bai.region_chunks(idx, tid, beg, end),
                    np.int64).reshape(-1, 2)
    try:
        pu = native_api.load_region_and_columnize(
            str(bam), ch, tid, beg, end, BAM_DEF_MASK, mapq, n_threads=1,
            drop_first_end_le=drop, flag_args=flag_args)
    except OSError as e:
        return str(e)
    c = pu.owner._ptr.contents
    pure = (None if not c.pure else
            np.ctypeslib.as_array(c.pure, (len(pu.ukeys),)).copy()
            if len(pu.ukeys) else np.zeros(0, np.uint8))
    return {"ukeys": np.array(pu.ukeys), "offsets": np.array(pu.offsets),
            "slots": np.array(pu.slots), "pure": pure}


def _same(a, b):
    if isinstance(a, str) or isinstance(b, str):
        assert a == b
        return
    for k in FIELDS:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _windows(header, window):
    return genome_windows(header.ref_lengths, window)


def _both(bam, regions, addresses, **kw):
    """[(host load, load with the builder at ``addresses``)] of each
    region, and the counters' deltas of the second."""
    want = [_load(bam, *r, **kw) for r in regions]
    c0 = _counts()
    with builder(addresses):
        got = [_load(bam, *r, **kw) for r in regions]
    return list(zip(want, got)), _delta(c0, _counts())


# -- the kernels' code on the host, in the card's place ---------------------

class Emul:
    def __init__(self, lib):
        self.lib = lib
        self.address = tuple(ctypes.cast(fn, ctypes.c_void_p).value for fn in
                             (lib.emul_card_pileup, lib.emul_card_release))

    def counts(self):
        """(calls, builds, buffers released)"""
        out = (ctypes.c_longlong * 3)()
        self.lib.emul_counts(out)
        return tuple(out)

    @contextlib.contextmanager
    def fused(self, f):
        self.lib.emul_set_fused(f)
        try:
            yield
        finally:
            self.lib.emul_set_fused(-1)


@pytest.fixture(scope="module")
def emul(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    _lib()
    so = tmp_path_factory.mktemp("emul") / "pileup_warp_emul.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CSRC), "-o", str(so),
                    str(HERE / "pileup_warp_emul.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.emul_set_fused.argtypes = [ctypes.c_int]
    return Emul(lib)


def _regions(name, pair30, pair300, edge):
    """(bam, regions, flag args, load keywords) of a case."""
    if name in ("pairgen30", "pairgen300"):
        pair = pair30 if name == "pairgen30" else pair300
        window = 5000 if name == "pairgen30" else 1000
        header = read_bam_header(str(pair.tumor))
        fa = _flag_args(pair.ref, header)
        return pair.tumor, _windows(header, window), fa, {}
    bam, header, fa = edge
    if name == "edge":  # 700 bp windows cut reads and N skips
        return bam, _windows(header, 700), fa, {"mapq": 20}
    if name == "edge_no_flags":
        return bam, _windows(header, 1100), None, {}
    if name == "edge_quirk":  # a contig's start with the carried quirk
        return bam, [(1, 0, 1000), (0, 0, 900)], fa, {"drop": 10**9}
    if name == "edge_whole_contigs":  # the last read's end closes it
        return bam, [(0, 0, 1 << 29), (1, 0, 1 << 29), (1, 2390, 2400)], \
            fa, {}
    raise KeyError(name)


CASES = ["pairgen30", "pairgen300", "edge", "edge_no_flags", "edge_quirk",
         "edge_whole_contigs"]


@pytest.mark.parametrize("case", CASES)
def test_emulated_build_equals_host_build(emul, pair30, pair300, edge, case):
    bam, regions, fa, kw = _regions(case, pair30, pair300, edge)
    e0 = emul.counts()
    pairs, d = _both(bam, regions, emul.address, flag_args=fa, **kw)
    for want, got in pairs:
        _same(want, got)
    built = sum(not isinstance(w, str) for w, _ in pairs)
    e1 = emul.counts()
    assert built > 0
    assert d["regions_card_built"] == built == e1[0] - e0[0]
    assert d["regions_host_built"] == 0
    # every pileup freed gave its buffer back
    assert e1[2] - e0[2] == built
    if case != "edge_quirk":
        assert sum(len(w["ukeys"]) for w, _ in pairs) > 0
    if fa is not None:
        assert any(w["pure"].any() for w, _ in pairs)
        assert any((~w["pure"].astype(bool)).any() for w, _ in pairs)


def test_edge_case_reaches_every_branch(edge):
    """The edge reads hold every CIGAR operation, sequences shorter than
    their CIGAR, empty ones, filtered reads, and deletions in the slots."""
    bam, header, fa = edge
    from somatic_sniper_tpu_torch.io.bam import read_bam

    _, reads = read_bam(str(bam))
    cigars = [reads.cigar[reads.cigar_off[r]:reads.cigar_off[r + 1]]
              for r in range(len(reads.pos))]
    assert {int(c) & 0xF for cg in cigars for c in cg} == set(range(9))
    # query bases the CIGAR reads (M, I, S, =, X) against the sequence's
    qlen = np.array([sum(int(c) >> 4 for c in cg if int(c) & 0xF in
                         (0, 1, 4, 7, 8)) for cg in cigars])
    lseq = np.asarray(reads.l_qseq)
    assert (lseq == 0).any() and ((lseq > 0) & (lseq < qlen)).any()
    assert ((np.asarray(reads.flag) & 0x704) != 0).any()
    assert (np.asarray(reads.mapq) < 20).any()
    got = _load(bam, 0, 0, EDGE_LEN[0], fa)
    assert ((got["slots"] >> 21) & 1).any()


# -- the flags' bound at the margin -----------------------------------------

def _threshold(slots, rcode, fk, gmin, fused):
    """L + gmin of the host's column_pure_ref on a pure column (None when
    the column is not pure): L's steps rounded once (an FMA, ``fused``)
    or twice (product, sum)."""
    m, L = 0, 0.0
    for s in (int(v) for v in slots):
        if (s >> 21) & 1:
            continue
        b = (s >> 16) & 0xF
        if b != rcode and b != 0:
            return None
        q, mq = (s >> 8) & 0xFF, s & 0xFF
        eff = min(q, mq)
        if eff < 4 and (q & 0x3F):
            eff = 4
        if eff > 0:
            f = float(fk[min(m, 255)])
            L = (float(Fraction(f) * eff + Fraction(L)) if fused
                 else f * eff + L)
            m += 1
    return None if m == 0 else L + float(gmin[m if m <= 255 else 254])


@pytest.fixture(scope="module")
def near_margin(pair30):
    """(bam, region, flag args without the margin, margins): a 1 kb region
    of the 30x pair and, for four of its pure columns whose bound differs
    between the fused and the twice-rounded chain, margins at each
    chain's bound and 1-2 ulps either side."""
    _lib()
    header = read_bam_header(str(pair30.tumor))
    blob, off, fk, gmin, _ = _flag_args(pair30.ref, header)
    region = (0, 4000, 5000)
    pu = _load(pair30.tumor, *region)
    margins = set()
    picked = 0
    for c in range(len(pu["ukeys"])):
        pos = int(pu["ukeys"][c]) & ((1 << 40) - 1)
        s = pu["slots"][pu["offsets"][c]:pu["offsets"][c + 1]]
        t = [_threshold(s, int(blob[off[0] + pos]), fk, gmin, f)
             for f in (True, False)]
        if t[0] is None or t[0] == t[1]:
            continue
        for v in t:
            for k in (-2, -1, 0, 1, 2):
                margins.add(float(v + k * np.spacing(v)))
        picked += 1
        if picked == 4:
            break
    assert picked == 4
    return pair30.tumor, region, (blob, off, fk, gmin), sorted(margins)


def test_flags_at_the_margin_match_the_host(emul, near_margin):
    """At margins within 2 ulps of the columns' bounds the card's flags
    are the host's.  Of the chain fused into FMAs and the chain rounded
    twice a step, forced in turn, exactly one gives the host's flags at
    every margin: the margins tell the two apart, and the loader's choice
    is the host's."""
    bam, region, tail, margins = near_margin
    matches = {0: True, 1: True}
    for margin in margins:
        fa = (*tail, margin)
        want = _load(bam, *region, flag_args=fa)
        with builder(emul.address):
            _same(want, _load(bam, *region, flag_args=fa))
            for f in matches:
                with emul.fused(f):
                    forced = _load(bam, *region, flag_args=fa)
                matches[f] &= np.array_equal(want["pure"], forced["pure"])
    assert sorted(matches.values()) == [False, True]


# -- the loader's hand-off --------------------------------------------------

class Returns:
    """A card builder that builds nothing and returns ``rc``."""

    def __init__(self, rc):
        self.calls, self.rc = 0, rc
        self.fns = CARD_FN(self._call), RELEASE_FN(lambda buf: None)
        self.address = tuple(ctypes.cast(f, ctypes.c_void_p).value
                             for f in self.fns)

    def _call(self, *args):
        self.calls += 1
        return self.rc


def test_declined_region_is_built_on_the_host(pair30):
    bam, header = pair30.tumor, read_bam_header(str(pair30.tumor))
    regions = _windows(header, 6000)
    declines = Returns(-1)
    pairs, d = _both(bam, regions, declines.address,
                     flag_args=_flag_args(pair30.ref, header))
    for want, got in pairs:
        _same(want, got)
    assert declines.calls == len(regions)
    assert d["regions_host_built"] == len(regions)
    assert d["regions_card_built"] == 0


def test_failed_call_fails_its_load(pair30):
    bam, header = pair30.tumor, read_bam_header(str(pair30.tumor))
    regions = _windows(header, 6000)
    fails = Returns(2)
    pairs, d = _both(bam, regions, fails.address)
    assert fails.calls == len(regions)
    for _, got in pairs:
        assert isinstance(got, str) and got.endswith(
            "pileup build failure (region, card: CUDA error 2)")
    assert d["regions_host_built"] == d["regions_card_built"] == 0


def test_refused_block_region_is_built_on_the_host(emul, pair30):
    """A region one of whose blocks the card inflater refused is built on
    the host; the others on the card."""
    from tests.test_torch_card_inflate import ZlibInflater

    bam, header = pair30.tumor, read_bam_header(str(pair30.tumor))
    regions = _windows(header, 40_000)  # 16 blocks or more a region
    fa = _flag_args(pair30.ref, header)
    want = [_load(bam, *r, flag_args=fa) for r in regions]
    inf = ZlibInflater(corrupt=1)
    c0 = _counts()
    with builder(emul.address, inf.address):
        got = [_load(bam, *r, flag_args=fa) for r in regions]
    d = _delta(c0, _counts())
    for w, g in zip(want, got):
        _same(w, g)
    assert inf.calls == len(regions) and d["blocks_card_redo"] == 1
    assert d["regions_host_built"] == 1
    assert d["regions_card_built"] == len(regions) - 1


def test_unsorted_records_fail_as_on_the_host(emul, tmp_path):
    recs = [encode_record(0, p, 60, 0, "ACGT" * 5, bytes([30] * 20),
                          [(20, "M")]) for p in (50, 10, 70)]
    bam = tmp_path / "unsorted.bam"
    write_bam(bam, ["u1"], [200], recs, level=1)
    # from the first record (after the header, in the first block) to the
    # end of the file
    first = len(bam_header_bytes(["u1"], [200]))
    chunks = np.array([[first, bam.stat().st_size << 16]], np.int64)
    errs = []
    for addr in (None, emul.address):
        with builder(addr):
            with pytest.raises(OSError) as e:
                native_api.load_region_and_columnize(str(bam), chunks, 0, 0,
                                                     200)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and errs[0].endswith(
        "BAM is not coordinate-sorted")


def test_whole_file_load_and_cpu_run_never_call_the_builder(emul, pair30):
    _lib()
    e0 = emul.counts()
    c0 = _counts()
    with builder(emul.address):
        native_api.load_and_columnize(str(pair30.tumor))
    native.set_card_pileup(emul.address)
    try:
        lines = []
        for _wi, _w, ls in call_pair_windows(
                str(pair30.tumor), str(pair30.normal), str(pair30.ref),
                fmt="vcf", precision="fast", window_size=6000, device="cpu"):
            lines.extend(ls)
    finally:
        native.set_card_pileup(None)
    d = _delta(c0, _counts())
    n = len(_windows(read_bam_header(str(pair30.tumor)), 6000))
    assert lines and emul.counts() == e0
    assert d["regions_card_built"] == 0 and d["regions_host_built"] == 2 * n


# -- the build on the card --------------------------------------------------

@pytest.fixture
def card():
    """(kernels' library, device index); skips without a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    from somatic_sniper_tpu_torch.ops import build

    return build.load_library(), torch.cuda.current_device()


def _card_address(device):
    from somatic_sniper_tpu_torch.ops import build

    native.set_card_inflate(None, device)  # the builder's device
    return build.card_pileup_addresses()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_card_build_equals_host_build(card, pair30, pair300, edge, case):
    lib, device = card
    bam, regions, fa, kw = _regions(case, pair30, pair300, edge)
    n0 = lib.sniper_pileup_card_launches()
    pairs, d = _both(bam, regions, _card_address(device), flag_args=fa, **kw)
    for want, got in pairs:
        _same(want, got)
    built = sum(not isinstance(w, str) for w, _ in pairs)
    assert d["regions_card_built"] == built > 0
    assert d["regions_host_built"] == 0
    assert 0 < lib.sniper_pileup_card_launches() - n0 <= built


@pytest.mark.cuda
def test_card_flags_at_the_margin(card, near_margin):
    bam, region, tail, margins = near_margin
    for margin in margins:
        fa = (*tail, margin)
        want = _load(bam, *region, flag_args=fa)
        with builder(_card_address(card[1])):
            got = _load(bam, *region, flag_args=fa)
        _same(want, got)


@pytest.mark.cuda
def test_card_refused_block_region_is_built_on_the_host(card, pair30):
    from tests.test_torch_card_inflate import ZlibInflater

    bam, header = pair30.tumor, read_bam_header(str(pair30.tumor))
    regions = _windows(header, 40_000)
    fa = _flag_args(pair30.ref, header)
    want = [_load(bam, *r, flag_args=fa) for r in regions]
    inf = ZlibInflater(corrupt=1)
    c0 = _counts()
    with builder(_card_address(card[1]), inf.address):
        got = [_load(bam, *r, flag_args=fa) for r in regions]
    d = _delta(c0, _counts())
    for w, g in zip(want, got):
        _same(w, g)
    assert d["regions_host_built"] == 1
    assert d["regions_card_built"] == len(regions) - 1


@pytest.mark.cuda
def test_card_build_at_the_deep300_window(card, tmp_path_factory):
    """A 250 kb window at 300x a sample (the deep300 cell's region load):
    no CUDA error, and the host's bytes."""
    lib, device = card
    pair = _pairgen(tmp_path_factory, "deep", 300.0, 250_000, n_contigs=1,
                    workers=0)
    header = read_bam_header(str(pair.tumor))
    fa = _flag_args(pair.ref, header)
    for bam in (pair.tumor, pair.normal):
        pairs, d = _both(bam, [(0, 0, 250_000)], _card_address(device),
                         flag_args=fa)
        for want, got in pairs:
            _same(want, got)
            assert len(want["slots"]) > 70_000_000
        assert d["regions_card_built"] == 1
