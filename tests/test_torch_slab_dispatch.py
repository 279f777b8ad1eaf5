"""The port's uniform-slab dispatcher (``parallel/slab.py``) and its
windowed path (``parallel/sharded.call_pair_windows``), held to the
invariants the JAX package's own tests hold its dispatcher to
(tests/test_slab.py, tests/test_slab_depth.py,
tests/test_deep_columns.py), on the CPU.

The output contract: record bytes are independent of slab packing.  The
slab size (``SNIPER_SLAB_B``), slabs that span windows, the zero-padded
partial slab (the run's last slab goes to the device like any other),
the max-live force flush, the mid-run depth upgrade and a pinned
``SNIPER_SLAB_D``, the deep columns scored on the host, the flag
surface (joint priors, LOH/GOR suppression, the classic and bed
formats) and the mode-mix ordering of the windowed path (a window that
cannot plan between slab windows) never change what is emitted.  Where a route scores on the host (exact) and another
on the device (fast), the two meet the fast contract
(``utils.contract.diff_records``).  The port's windowed output is also
held to the JAX package's on the same pair under the fast contract.

Not ported: the JAX package's threshold below which a run, or its last
slab, is scored on the host.  It hides a probed round trip to a remote
accelerator, which a card on the host's PCIe does not have; the port
reads no such variable, which ``test_retired_variables_change_nothing``
holds.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from somatic_sniper_tpu.parallel.sharded import (  # noqa: E402
    call_pair_windows as jax_call_pair_windows)
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.io.bam_writer import (  # noqa: E402
    encode_record, write_bam)
from somatic_sniper_tpu_torch.io.fasta import FastaFile  # noqa: E402
from somatic_sniper_tpu_torch.io.native_api import PairedPlan  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402
from somatic_sniper_tpu_torch.parallel import slab as slab_mod  # noqa: E402
from somatic_sniper_tpu_torch.parallel.sharded import (  # noqa: E402
    call_pair_windows)
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402


def _pair(d):
    return str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa")


def _lines_windowed(d, window_size, fmt="vcf", precision="fast", **kw):
    out = []
    for _wi, _w, lines in call_pair_windows(
            *_pair(d), precision=precision, fmt=fmt,
            window_size=window_size, device="cpu", **kw):
        out.extend(lines)
    return out


def _records(d, **kw):
    return list(runner.call_pair(*_pair(d), precision="fast", device="cpu",
                                 **kw))


def _delta(s0, s1, key):
    return s1.get(key, 0) - s0.get(key, 0)


def test_tiny_slabs_cross_window_same_output(monkeypatch, data_dir):
    """Slabs of 16 columns spanning the boundaries of 10 kb windows give
    the bytes of the default packing."""
    d = data_dir / "e2e" / "sim1"
    baseline = _lines_windowed(d, 200_000)
    monkeypatch.setenv("SNIPER_SLAB_B", "16")
    s0 = STATS.snapshot()
    got = _lines_windowed(d, 10_000)
    s1 = STATS.snapshot()
    assert got == baseline
    assert _delta(s0, s1, "slabs_dispatched") >= 2


def test_partial_slab_padding_invisible(monkeypatch, data_dir):
    """A run that fits in one zero-padded partial slab equals a run cut
    into many full slabs: padded rows never emit."""
    d = data_dir / "e2e" / "sim1"
    big = _lines_windowed(d, 1_000_000)
    monkeypatch.setenv("SNIPER_SLAB_B", "128")
    assert _lines_windowed(d, 1_000_000) == big


SLAB_B = 128


def _sim1_plan(d):
    """sim1's pileups and the plan of every column the two samples share
    (no prefilter), reordered so that the columns the prefilter keeps
    come first: a plan's first n columns then hold records."""
    params = ModelParams()
    tabs = build_tables(params)
    tumor, normal, ref = _pair(d)
    header_t, pu_t, _, pu_n = runner._load_pileups(tumor, normal, params)
    fasta = FastaFile(ref)
    ref_blob, ref_off = runner._ref_blob(fasta, header_t)
    every, kept = (runner.make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, pf,
                                    cns_mode="proof") for pf in (False, True))
    first = np.isin(every.keys, kept.keys)
    order = np.concatenate([np.nonzero(first)[0], np.nonzero(~first)[0]])
    return (params, tabs, runner.RefCache(fasta, header_t), pu_t, pu_n,
            every, order)


def _slab_lines(monkeypatch, sim1, n, slab_b):
    """The vcf lines of the plan's first n columns through one window of
    a dispatcher whose slabs hold ``slab_b`` columns."""
    params, tabs, refcache, pu_t, pu_n, every, order = sim1
    sel = order[:n]
    plan = PairedPlan(*(getattr(every, f)[sel] for f in
                        ("keys", "ti", "ni", "d_t", "d_n", "ref16")),
                      np.array([0, n], np.int64))
    monkeypatch.setenv("SNIPER_SLAB_B", str(slab_b))
    disp = slab_mod.TorchSlabDispatcher(
        lambda: device_tables(tabs, "cpu"), tabs, params, refcache, "cpu",
        "vcf")
    disp.add_window(0, None, pu_t, pu_n, plan)
    return [ln for _, _, lines in disp.finish() for ln in lines]


@pytest.mark.parametrize("n", [1, 100, SLAB_B - 1, SLAB_B + 1],
                         ids=["1", "100", "B-1", "B+1"])
def test_last_partial_slab_goes_to_the_device(monkeypatch, data_dir, n):
    """A run's last slab, partly filled, is dispatched like any other:
    the first n columns of a plan in slabs of 128 give the bytes of one
    slab of exactly n columns (no padding), every column scored on the
    device and none on the host."""
    sim1 = _sim1_plan(data_dir / "e2e" / "sim1")
    assert len(sim1[-1]) > SLAB_B + 1
    monkeypatch.setenv("SNIPER_SLAB_D", "255")
    want = _slab_lines(monkeypatch, sim1, n, n)
    s0 = STATS.snapshot()
    got = _slab_lines(monkeypatch, sim1, n, SLAB_B)
    s1 = STATS.snapshot()
    assert got == want
    assert len(got) > 0 or n == 1
    assert _delta(s0, s1, "device_columns") == n
    assert _delta(s0, s1, "host_deep_columns") == 0
    assert _delta(s0, s1, "slabs_dispatched") == -(-n // SLAB_B)
    assert not [k for k in s1 if k.startswith("host_tail")]


ROUTE_COUNTERS = ("columns_scored", "device_columns", "host_deep_columns",
                  "slabs_dispatched", "records_emitted")


@pytest.mark.parametrize("name,value", [("NO_MESH", "1"),
                                        ("DEVICE_MIN_COLS", "1000000")])
def test_retired_variables_change_nothing(monkeypatch, data_dir, name,
                                          value):
    """Neither variable of the JAX package's split over devices nor of
    its host threshold is read by the port: set, the windowed and the
    whole-file fast runs give the same bytes through the same routes."""
    d = data_dir / "e2e" / "sim1"

    def run():
        s0 = STATS.snapshot()
        out = (_lines_windowed(d, 20_000), _records(d, fmt="vcf"))
        s1 = STATS.snapshot()
        return out, {k: _delta(s0, s1, k) for k in ROUTE_COUNTERS}

    base = run()
    assert base[0][0] and base[1]["device_columns"] > 0
    monkeypatch.setenv(f"SNIPER_{name}", value)
    assert run() == base


def test_max_live_force_flush(monkeypatch, data_dir):
    """Sparse windows under a huge slab still flush (bounded held-window
    memory) and yield the same records.  The depth is pinned at the
    first window, so that the slab fills from the second on and the
    bound of two held windows is what flushes it."""
    d = data_dir / "e2e" / "sim1"
    baseline = _lines_windowed(d, 200_000)
    monkeypatch.setenv("SNIPER_SLAB_B", "16384")
    monkeypatch.setattr(slab_mod, "D_SAMPLE_WINDOWS", 1)
    orig_init = slab_mod.TorchSlabDispatcher.__init__
    flushed = []

    def init2(self, *a, **kw):
        kw["max_live_windows"] = 2
        orig_init(self, *a, **kw)
        flushed.append(self)

    monkeypatch.setattr(slab_mod.TorchSlabDispatcher, "__init__", init2)
    s0 = STATS.snapshot()
    got = _lines_windowed(d, 2_000)
    s1 = STATS.snapshot()
    assert got == baseline
    assert flushed and flushed[0].max_live == 2
    # a slab of 16384 holds every survivor of the pair (81): only the
    # bound flushes more than one
    assert _delta(s0, s1, "slabs_dispatched") >= 2


def test_whole_file_and_windowed_agree(data_dir):
    d = data_dir / "e2e" / "sim1"
    assert _records(d, fmt="vcf") == _lines_windowed(d, 50_000)


def test_windowed_output_matches_the_jax_package(monkeypatch, data_dir):
    """The port's windowed fast output against the JAX package's on the
    same pair, both packed into slabs of 16: the fast contract, every
    call equal."""
    d = data_dir / "e2e" / "sim1"
    monkeypatch.setenv("SNIPER_SLAB_B", "16")
    got = _lines_windowed(d, 10_000)
    want = []
    for _wi, _w, lines in jax_call_pair_windows(
            *_pair(d), precision="fast", fmt="vcf", window_size=10_000):
        want.extend(lines)
    assert got
    diff_records(got, want, "vcf")


# the non-default flag surface through the windowed slab dispatcher
FLAG_CASES = {
    "joint": (ModelParams(use_joint_priors=True,
                          somatic_mutation_rate=0.001), "vcf"),
    "loh_gor": (ModelParams(include_loh=False, include_gor=False,
                            min_somatic_qual=0), "vcf"),
    "classic": (ModelParams(), "classic"),
    "bed": (ModelParams(), "bed"),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_flag_surface_packing_invariant(monkeypatch, data_dir, case):
    params, fmt = FLAG_CASES[case]
    d = data_dir / "e2e" / "sim1"
    baseline = _lines_windowed(d, 200_000, fmt=fmt, params=params)
    assert baseline, case
    monkeypatch.setenv("SNIPER_SLAB_B", "16")
    assert _lines_windowed(d, 10_000, fmt=fmt, params=params) == baseline


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_mode_mix_ordering(monkeypatch, data_dir, case):
    """A window that cannot plan between slab windows sends
    ``call_pair_windows`` through its mode-mix ordering guards: the open
    dispatcher finishes before that window yields, and records stay in
    window order.  The
    patch is aimed at the name ``parallel/sharded.py`` binds by import,
    ``parallel.sharded.can_plan``."""
    params, fmt = FLAG_CASES[case]
    d = data_dir / "e2e" / "sim1"
    baseline = _lines_windowed(d, 2_000, fmt=fmt, params=params)
    calls = {"n": 0}
    orig = sharded.can_plan

    def flaky_can_plan(pu_t, pu_n, packed16):
        calls["n"] += 1
        if calls["n"] % 3 == 2:  # every third window takes the batch path
            return False
        return orig(pu_t, pu_n, packed16)

    monkeypatch.setattr(sharded, "can_plan", flaky_can_plan)
    s0 = STATS.snapshot()
    got = _lines_windowed(d, 2_000, fmt=fmt, params=params)
    s1 = STATS.snapshot()
    assert calls["n"] > 3, "the pair must span several windows"
    assert _delta(s0, s1, "batches_dispatched") > 0
    assert _delta(s0, s1, "slabs_dispatched") > 0
    assert got == baseline


# -- the slab depth -----------------------------------------------------------

BASES = "ACGT"
READ_LEN = 60
CONTIG_LEN = 40_000
VAR_STRIDE = 503  # a somatic SNV every ~503 bp


def _reads(seq, depth, tumor, rng):
    """Sorted 60M reads at uniform coverage; tumor reads carry a 50% VAF
    alt at every VAR_STRIDE-th position."""
    n = CONTIG_LEN * depth // READ_LEN
    starts = np.sort((np.arange(n) * (CONTIG_LEN - READ_LEN))
                     // max(n - 1, 1))
    var_pos = set(range(VAR_STRIDE, CONTIG_LEN - READ_LEN, VAR_STRIDE))
    out = []
    for i, s in enumerate(starts.tolist()):
        bases = list(seq[s:s + READ_LEN])
        if tumor and i % 2 == 0:
            for j, p in enumerate(range(s, s + READ_LEN)):
                if p in var_pos:
                    bases[j] = BASES[(BASES.index(bases[j]) + 1) % 4]
        out.append((s, "".join(bases), 16 if i % 2 else 0))
    return out


def _build_pair(d: Path):
    """Contig one at ~6x, contig two at ~90x: a shallow first window
    that would pin a small depth."""
    rng = np.random.default_rng(99)
    seqs = ["".join(BASES[i] for i in rng.integers(0, 4, CONTIG_LEN))
            for _ in range(2)]
    names = ["shal", "deep"]
    with open(d / "ref.fa", "w") as fh:
        for nm, sq in zip(names, seqs):
            fh.write(f">{nm}\n")
            for i in range(0, CONTIG_LEN, 60):
                fh.write(sq[i:i + 60] + "\n")
    off, fai = 0, []
    for nm in names:
        off += len(nm) + 2
        fai.append(f"{nm}\t{CONTIG_LEN}\t{off}\t60\t61")
        off += CONTIG_LEN + CONTIG_LEN // 60
    (d / "ref.fa.fai").write_text("\n".join(fai) + "\n")
    qual = bytes([30]) * READ_LEN
    for sample, tumor in (("tumor", True), ("normal", False)):
        recs = []
        for tid, (sq, dep) in enumerate(zip(seqs, (6, 90))):
            for k, (s, bases, flag) in enumerate(_reads(sq, dep, tumor,
                                                        rng)):
                recs.append(encode_record(
                    tid, s, 50, flag, bases, qual, [(READ_LEN, "M")],
                    read_name=f"r{tid}_{k}"))
        write_bam(d / f"{sample}.bam", names, [CONTIG_LEN, CONTIG_LEN], recs)


@pytest.fixture(scope="module")
def shallow_first_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("shallow_first_torch")
    _build_pair(d)
    return d


@pytest.fixture(scope="module")
def shallow_first_exact(shallow_first_pair):
    lines = _lines_windowed(shallow_first_pair, 10_000, precision="exact")
    assert lines, "the pair must emit records"
    return lines


def test_shallow_first_window_upgrades_depth(monkeypatch, capfd,
                                             shallow_first_pair,
                                             shallow_first_exact):
    """With small evidence thresholds the dispatcher upgrades the depth
    it pinned from the shallow contig once, mid-run, and moves the deep
    contig's columns onto the device; the output meets the fast
    contract against exact."""
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 64)
    s0 = STATS.snapshot()
    fast = _lines_windowed(shallow_first_pair, 10_000)
    s1 = STATS.snapshot()
    diff_records(fast, shallow_first_exact, "vcf")
    assert "upgrading slab depth" in capfd.readouterr().err
    deep = _delta(s0, s1, "host_deep_columns")
    dev = _delta(s0, s1, "device_columns")
    scored = _delta(s0, s1, "columns_scored")
    assert dev + deep == scored
    assert deep < 0.6 * scored, (deep, dev, scored)
    assert dev > 0


def test_shallow_first_window_no_upgrade_still_correct(
        monkeypatch, shallow_first_pair, shallow_first_exact):
    """With the evidence out of reach the run keeps the shallow depth and
    scores the deep contig on the host: the output still holds."""
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 10**9)
    s0 = STATS.snapshot()
    fast = _lines_windowed(shallow_first_pair, 10_000)
    s1 = STATS.snapshot()
    diff_records(fast, shallow_first_exact, "vcf")
    assert _delta(s0, s1, "host_deep_columns") > 0


def test_pinned_d_never_upgrades(monkeypatch, capfd, shallow_first_pair,
                                 shallow_first_exact):
    """An explicit SNIPER_SLAB_D is never second-guessed."""
    monkeypatch.setattr(slab_mod, "D_SAMPLE_COLS", 64)
    monkeypatch.setenv("SNIPER_SLAB_D", "16")
    s0 = STATS.snapshot()
    fast = _lines_windowed(shallow_first_pair, 10_000)
    s1 = STATS.snapshot()
    diff_records(fast, shallow_first_exact, "vcf")
    assert "upgrading slab depth" not in capfd.readouterr().err
    assert _delta(s0, s1, "slabs_at_depth_16") > 0
    assert all(_delta(s0, s1, f"slabs_at_depth_{D}") == 0
               for D in slab_mod.ALLOWED_D if D != 16)


# -- deep columns -------------------------------------------------------------

@pytest.mark.parametrize("case", ["sim1", "sim2_deep"])
def test_deep_columns_host_scored_same_output(monkeypatch, data_dir, case):
    """Slab depth 16: every 30x column is deep and takes the native
    exact host scorer, with the records of the all-device run and no
    extra device work."""
    d = data_dir / "e2e" / case
    baseline = _records(d)
    monkeypatch.setenv("SNIPER_SLAB_D", "16")
    s0 = STATS.snapshot()
    got = _records(d)
    s1 = STATS.snapshot()
    assert got == baseline
    deep = _delta(s0, s1, "host_deep_columns")
    assert deep > 0, "expected host-scored deep columns with D=16"
    assert _delta(s0, s1, "device_columns") + deep == \
        _delta(s0, s1, "columns_scored")


def test_mostly_deep_run_host_dominates(monkeypatch, data_dir):
    """With a degenerate slab depth nearly every column goes to the
    host; the records stay the same."""
    d = data_dir / "e2e" / "sim2_deep"
    baseline = _records(d)
    monkeypatch.setenv("SNIPER_SLAB_D", "2")
    s0 = STATS.snapshot()
    got = _records(d)
    s1 = STATS.snapshot()
    assert got == baseline
    assert _delta(s0, s1, "host_deep_columns") >= \
        0.9 * _delta(s0, s1, "columns_scored")


def test_choose_d():
    assert slab_mod.choose_d(np.array([], np.int32)) is None
    assert slab_mod.choose_d(np.full(100, 30)) == 32
    assert slab_mod.choose_d(np.full(100, 33)) == 48
    assert slab_mod.choose_d(np.full(100, 50)) == 64
    # the tail beyond the coverage quantile does not widen the slab
    dm = np.r_[np.full(999, 40), np.array([5000])]
    assert slab_mod.choose_d(dm) == 48
    # beyond the ladder: the widest slab (the rest goes to the host)
    assert slab_mod.choose_d(np.full(100, 5000)) == slab_mod.ALLOWED_D[-1]
