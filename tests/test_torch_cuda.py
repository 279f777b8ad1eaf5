"""The torch port's CUDA kernels on the card, against their plain torch
versions on the same inputs.

Marked ``cuda``: every test skips without a CUDA device.  On a machine
with one card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which these tests
do not use; they import the port alone.)

Tolerances as in the CPU tests: c/rms and the assembly exact, the f32
class sums within rtol 1e-6, atol 1e-5 (summation order), the rows
within the fast contract.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.torch_port_util import (SCORE_PAD, deep_raw32,  # noqa: E402
                                   filtered_lines, hazard_column,
                                   random_raw32, random_slab, random_stacked,
                                   random_u32, score_inputs, to_packed16)

from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import device_tables  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402

pytestmark = pytest.mark.cuda
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    from somatic_sniper_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _lanes(B, D, seed, dev):
    slots, nk, _, ref16 = random_raw32(B, D, seed)
    return (torch.from_numpy(slots.view(np.int32)).to(dev),
            torch.from_numpy(nk).to(dev), torch.from_numpy(ref16).to(dev))


@pytest.mark.parametrize("B,D", [(8192, 48), (300, 16), (257, 100),
                                 (1024, 255)])
def test_kernels_match_plain_on_card(dev, B, D):
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    s, nk, r = _lanes(B, D, D, dev)
    before = dict(gk.LAUNCHES)
    k = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    p = gk.accumulate32_plain(s, nk, r, dtabs.fk_weights, 60)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    torch.testing.assert_close(k[0], p[0], rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(k[1], p[1], rtol=1e-6, atol=1e-5)
    args = (k[0], k[1], k[2], nk, *dtabs.assembly_tables(D))
    lk, mlk = gk.assembly10(*args)
    lk_p, mlk_p = gk.assembly10_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)
    assert gk.LAUNCHES["accumulate32"] == before["accumulate32"] + 1
    assert gk.LAUNCHES["assembly10"] == before["assembly10"] + 1
    # fixed-order sums: a second launch gives the same bits
    k2 = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))


@pytest.mark.parametrize("shift", [5, -1])
def test_assembly10_card_rejects_counts_past_the_table(dev, shift):
    """Counts that would index past coef_sub/lhet_sub raise on the card as
    on the CPU, and the kernel reads no table for them."""
    B, NK = 300, 17
    e = torch.zeros((B, 4), device=dev)
    c = torch.full((B, 4), shift, dtype=torch.int32, device=dev)
    c[:-1] = 0  # one offending column among good ones
    n = torch.ones(B, dtype=torch.int32, device=dev)
    tabs = (torch.zeros((60, NK, NK), device=dev),
            torch.zeros((NK, NK), device=dev))
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10(e, e, c, n, *tabs)
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10_plain(e, e, c, n, *tabs)
    torch.cuda.synchronize()  # no sticky fault from the kernel


@pytest.mark.parametrize("B", [1, 17, 1001])
def test_assembly10_card_odd_batch(dev, B):
    """Sixteen lanes a column, two columns a warp: at an odd B the last
    warp holds one column (at B = 1 the only one) and its other half
    takes part in the shuffles without loading or storing."""
    D = 48
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    s, nk, r = _lanes(B, D, 7, dev)
    e, f, c, _ = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    args = (e, f, c, nk, *dtabs.assembly_tables(D))
    lk, mlk = gk.assembly10(*args)
    lk_p, mlk_p = gk.assembly10_plain(*args)
    lk2, mlk2, err = gk.assembly10_launch(*args)
    torch.cuda.synchronize()
    assert torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)
    assert torch.equal(lk, lk2) and torch.equal(mlk, mlk2)
    assert int(err) == 0


@pytest.mark.parametrize("shift", [5, -1])
def test_assembly10_card_offenders_beside_good_columns(dev, shift):
    """Columns whose counts index past the tables share warps with good
    columns: the launch flags them and zeroes their rows, and every good
    column still equals the plain version's."""
    B, D = 301, 16
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    s, nk, r = _lanes(B, D, 11, dev)
    e, f, c, _ = gk.accumulate32(s, nk, r, dtabs.fk_weights, 60)
    tabs = dtabs.assembly_tables(D)
    lk_p, mlk_p = gk.assembly10_plain(e, f, c, nk, *tabs)
    bad = torch.zeros(B, dtype=torch.bool, device=dev)
    bad[[0, 5, 6, 150, 299, 300]] = True  # either half of a warp, and both
    c_bad = torch.where(bad[:, None], c + shift * (D + 1), c)
    lk, mlk, err = gk.assembly10_launch(e, f, c_bad, nk, *tabs)
    torch.cuda.synchronize()
    assert int(err) == 1
    assert torch.equal(lk[~bad], lk_p[~bad])
    assert torch.equal(mlk[~bad], mlk_p[~bad])
    assert int(lk[bad].abs().max()) == 0 and int(mlk[bad].abs().max()) == 0
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10(e, f, c_bad, nk, *tabs)


def test_call_batch_packed_card_matches_cpu(dev):
    B, D = 2048, 48
    stacked, meta = random_slab(B, D, seed=3)
    params = T.ModelParams(min_somatic_qual=0)
    tabs = T.build_tables(params)
    res = {}
    for d in (torch.device("cpu"), dev):
        out = ts.call_batch_packed(
            torch.from_numpy(stacked.view(np.int32)).to(d),
            torch.from_numpy(meta).to(d), device_tables(tabs, d), params)
        res[d.type] = (int(out.count), out.rows.cpu().numpy().astype(int))
    (n_c, rows_c), (n_g, rows_g) = res["cpu"], res["cuda"]
    assert n_c == n_g > 0
    assert np.abs(rows_c[:n_c] - rows_g[:n_c]).max() <= 1
    assert (rows_c[:n_c] == rows_g[:n_c]).all(axis=1).mean() >= 0.99


def test_cli_fast_on_card_golden(dev, tmp_path):
    from somatic_sniper_tpu_torch.cli.main import main

    out = tmp_path / "out.vcf"
    assert main(["--precision", "fast", "--device", "cuda", "-F", "vcf",
                 "-f", str(DATA / "small.fa"), str(DATA / "t-small.bam"),
                 str(DATA / "n-small.bam"), str(out)]) == 0
    diff_records(filtered_lines(out), filtered_lines(DATA / "expected.vcf"),
                 "vcf")


def _assert_sums(k, p, D):
    rtol = 1e-6 if D <= 255 else 1e-4
    torch.testing.assert_close(k[0], p[0], rtol=rtol, atol=1e-5)
    torch.testing.assert_close(k[1], p[1], rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B,D", [(4096, 16), (300, 48), (257, 128),
                                 (64, 1024), (2, 20000), (1001, 31),
                                 (1001, 33), (517, 65), (131, 129),
                                 (67, 255), (3, 1)])
def test_rank_kernels_match_plain_on_card(dev, B, D):
    """accumulate and accumulate16 against their plain versions at every
    layout: a warp a column with 1, 2, 4 and 8 keys a lane (P = 32 .. 256,
    at the depths on both sides of each step, and at B that fills no whole
    block), a block a column with keys in shared memory, and with keys in
    the global scratch (D > 16384)."""
    w = device_tables(T.build_tables(T.ModelParams()), dev).fk_weights
    slots, depth, ref16 = random_u32(B, D, D)
    depth[0] = D  # one full column
    s16, nk, _ = to_packed16(slots, depth, ref16)
    s, dp, r = (torch.from_numpy(a).to(dev)
                for a in (slots.view(np.int32), depth, ref16))
    before = dict(gk.LAUNCHES)
    k = gk.accumulate(s, dp, r, w, 60)
    p = gk.accumulate_plain(s, dp, r, w, 60)
    for a, b in zip(k[2:], p[2:]):
        assert torch.equal(a, b)
    _assert_sums(k, p, D)
    s16_d, nk_d = torch.from_numpy(s16).to(dev), torch.from_numpy(nk).to(dev)
    k16 = gk.accumulate16(s16_d, nk_d, w)
    p16 = gk.accumulate16_plain(s16_d, nk_d, w)
    torch.cuda.synchronize()
    assert torch.equal(k16[2], p16[2])
    _assert_sums(k16, p16, D)
    assert gk.LAUNCHES["accumulate"] == before["accumulate"] + 1
    assert gk.LAUNCHES["accumulate16"] == before["accumulate16"] + 1
    # fixed-order sums: a second launch gives the same bits
    k2 = gk.accumulate(s, dp, r, w, 60)
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    k16_2 = gk.accumulate16(s16_d, nk_d, w)
    assert all(torch.equal(a, b) for a, b in zip(k16, k16_2))


@pytest.mark.parametrize("B,D", [(1001, 31), (1001, 33), (517, 65),
                                 (131, 129), (67, 255), (3, 1)])
@pytest.mark.parametrize("encoding", ["raw32", "u32", "u16"])
def test_fused_kernels_match_two_step_on_card(dev, encoding, B, D):
    """An accumulate and the assembly in one launch against the two
    launches: the stand-alone accumulate kernel's sums through
    assembly10_plain give the same lk and min_lk bit for bit, rms and n
    are equal, a second launch gives the same bits, and only the fused
    kernel's counter moves."""
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    w, tabs = dtabs.fk_weights, dtabs.assembly_tables(D)
    if encoding == "raw32":
        s, nk, r = _lanes(B, D, D, dev)
        e, f, c, rms = gk.accumulate32(s, nk, r, w, 60)
        want = (*gk.assembly10_plain(e, f, c, nk, *tabs), rms)
        name, fused = "glfgen32", lambda: gk.glfgen32(s, nk, r, w, *tabs, 60)
    else:
        slots, depth, ref16 = random_u32(B, D, D)
        depth[0] = D  # one full column
        if encoding == "u32":
            s, dp, r = (torch.from_numpy(a).to(dev)
                        for a in (slots.view(np.int32), depth, ref16))
            e, f, c, rms, n = gk.accumulate(s, dp, r, w, 60)
            want = (*gk.assembly10_plain(e, f, c, n, *tabs), rms, n)
            name = "glfgen"
            fused = lambda: gk.glfgen_u32(s, dp, r, w, *tabs, 60)  # noqa: E731
        else:
            s16, nk, _ = to_packed16(slots, depth, ref16)
            s, nk = torch.from_numpy(s16).to(dev), torch.from_numpy(nk).to(dev)
            e, f, c = gk.accumulate16(s, nk, w)
            want = gk.assembly10_plain(e, f, c, nk, *tabs)
            name, fused = "glfgen16", lambda: gk.glfgen16(s, nk, w, *tabs)
    before = dict(gk.LAUNCHES)
    got, again = fused(), fused()
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b, c2 in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c2)
    after = dict(gk.LAUNCHES)
    assert after.pop(name) == before.pop(name) + 2
    assert after == before


def test_glfgen_batch_card_routes_by_depth(dev):
    """To depth 255 glfgen_batch launches the fused kernel alone; deeper,
    the accumulate and assembly10."""
    from somatic_sniper_tpu_torch.models import glfgen as tg

    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    for D, want in ((255, {"glfgen": 1}),
                    (256, {"accumulate": 1, "assembly10": 1})):
        slots, depth, ref16 = random_u32(64, D, D)
        cols = tg.ColumnBatch(*(torch.from_numpy(a).to(dev) for a in
                                (slots.view(np.int32), depth, ref16)))
        gk.reset_launches()
        on_card = tg.glfgen_batch(cols, dtabs, 60)
        torch.cuda.synchronize()
        assert {k: v for k, v in gk.LAUNCHES.items() if v} == want
        cpu = tg.glfgen_batch(
            tg.ColumnBatch(*(t.cpu() for t in cols[:3])),
            device_tables(T.build_tables(T.ModelParams()), "cpu"), 60)
        assert torch.equal(on_card.depth.cpu(), cpu.depth)
        assert torch.equal(on_card.rms_mapq.cpu(), cpu.rms_mapq)
        assert int((on_card.lk.cpu() - cpu.lk).abs().max()) <= 1


@pytest.mark.parametrize("packed16", [True, False])
def test_call_batch_stacked_card_matches_cpu(dev, packed16):
    """The batch path's i32 rows on the card against the CPU (plain
    kernels): same count, rows within the fast contract."""
    B, D = 4096, 40
    stacked, meta = random_stacked(B, D, 5, packed16)
    params = T.ModelParams(min_somatic_qual=0)
    tabs = T.build_tables(params)
    s = stacked if packed16 else stacked.view(np.int32)
    res = {}
    for d in (torch.device("cpu"), dev):
        out = ts.call_batch_stacked(
            torch.from_numpy(s).to(d), torch.from_numpy(meta).to(d),
            device_tables(tabs, d), params, packed16=packed16, max_emit=B)
        res[d.type] = (int(out.count), out.rows.cpu().numpy().astype(int))
    (n_c, rows_c), (n_g, rows_g) = res["cpu"], res["cuda"]
    assert n_c == n_g > 0
    assert np.abs(rows_c[:n_c] - rows_g[:n_c]).max() <= 1
    assert (rows_c[:n_c] == rows_g[:n_c]).all(axis=1).mean() >= 0.99


def test_cli_fast_on_card_without_native_golden(dev, tmp_path, monkeypatch):
    """The whole-file CLI with the native loaders switched off: pure-
    Python decode, u16 batches through glfgen16 on the card (accumulate16
    and assembly10 only for a batch deeper than 255)."""
    from somatic_sniper_tpu_torch.cli.main import main
    from somatic_sniper_tpu_torch.io import native_api

    monkeypatch.setattr(native_api, "available", lambda: False)
    gk.reset_launches()
    out = tmp_path / "out.vcf"
    assert main(["--precision", "fast", "--device", "cuda", "-F", "vcf",
                 "-f", str(DATA / "small.fa"), str(DATA / "t-small.bam"),
                 str(DATA / "n-small.bam"), str(out)]) == 0
    assert gk.LAUNCHES["glfgen16"] > 0  # shallow batches: one launch
    assert gk.LAUNCHES["accumulate16"] == gk.LAUNCHES["assembly10"]
    assert gk.LAUNCHES["accumulate32"] == gk.LAUNCHES["glfgen32"] == 0
    diff_records(filtered_lines(out), filtered_lines(DATA / "expected.vcf"),
                 "vcf")


def test_accumulate_card_ranks_by_raw_eff(dev):
    """The hazard column on the card: the kernel follows the reference's
    raw-eff rank (esum[A] = 35.4868), not the Pallas kernel's floored
    one (35.610474)."""
    w = device_tables(T.build_tables(T.ModelParams()), dev).fk_weights
    slots, depth, ref16 = hazard_column()
    s, dp, r = (torch.from_numpy(a).to(dev)
                for a in (slots.view(np.int32), depth, ref16))
    k = gk.accumulate(s, dp, r, w, 60)
    p = gk.accumulate_plain(s, dp, r, w, 60)
    torch.cuda.synchronize()
    assert torch.equal(k[2], p[2]) and torch.equal(k[4], p[4])
    _assert_sums(k, p, 3)
    assert abs(float(k[0][0, 0]) - 35.4868) < 1e-4


@pytest.mark.parametrize("B,D", [(300, 40), (64, 300)])
def test_exact_glfgen_card_equals_cpu(dev, B, D):
    """The f64 exact glfgen gives the same bits on the card as on the
    CPU (no fused multiply-add, IEEE sqrt and division), the c_tot > 255
    rescale included."""
    from somatic_sniper_tpu_torch.models.glfgen import (ColumnBatch,
                                                        glfgen_batch)

    slots, depth, ref16 = random_u32(B, D, seed=D)
    if D > 255:
        depth[:8] = D
        slots[:8] = (slots[:8] | (30 << 8) | 40) & ~np.uint32(1 << 21)
    tabs = T.build_tables(T.ModelParams())
    res = []
    for where in (torch.device("cpu"), dev):
        cb = ColumnBatch(*(torch.from_numpy(a).to(where) for a in
                           (slots.view(np.int32), depth, ref16)))
        res.append(glfgen_batch(cb, device_tables(tabs, where, "exact"), 60,
                                "exact"))
    for name, a, b in zip(res[0]._fields, *res):
        if a is None:  # no error word: the exact path has none
            assert b is None, name
            continue
        assert b.device == dev
        assert torch.equal(a, b.cpu()), name
    if D > 255:
        assert int(res[1].depth.max()) > 255


def test_cli_exact_on_card_without_native_golden(dev, tmp_path, monkeypatch):
    from somatic_sniper_tpu_torch.cli.main import main
    from somatic_sniper_tpu_torch.io import native_api
    from somatic_sniper_tpu_torch.utils.stats import STATS

    monkeypatch.setattr(native_api, "available", lambda: False)
    out = tmp_path / "exact.vcf"
    STATS.reset()
    assert main(["--precision", "exact", "--device", "cuda", "-F", "vcf",
                 "-f", str(DATA / "small.fa"), str(DATA / "t-small.bam"),
                 str(DATA / "n-small.bam"), str(out)]) == 0
    assert STATS.snapshot().get("batches_dispatched", 0) > 0
    assert filtered_lines(out) == filtered_lines(DATA / "expected.vcf")


@pytest.mark.parametrize("B,D", [(8192, 48), (2048, 64)])
def test_bench_kernel_on_card(dev, B, D):
    """``utils.mfu.bench_kernel`` with no device named runs on the card:
    every step, replayed or eager, launches glfgen32 twice, score_columns
    once and no stand-alone kernel (a capture's warm-up counts none), and
    the launch floor it measures gives a launch bound."""
    from somatic_sniper_tpu_torch.utils import mfu

    gk.reset_launches()
    r = mfu.bench_kernel(B=B, D=D, iters=8)
    assert r.steps_run >= 2 + 2 * (2 + 8)
    assert gk.LAUNCHES["glfgen32"] == 2 * r.steps_run
    assert gk.LAUNCHES["score_columns"] == r.steps_run
    assert sum(gk.LAUNCHES.values()) == 3 * r.steps_run
    assert r.kernel_launches == {"glfgen32": 2, "score_columns": 1}
    assert r.cols_per_sec > 0 and 0 < r.est_mfu < 1
    assert r.eager_slab_s > 0 and r.eager_host_queue_s > 0
    assert r.graph_run_s > r.measured_slab_s > 0
    assert 0 < r.launch_floor_s < 1e-3 and 0 < r.stream_launch_floor_s < 1e-3
    assert r.bound_launch_s == r.launches_per_step * r.launch_floor_s
    assert r.measured_slab_s > max(r.bound_hbm_s, r.bound_compute_s)
    assert r.verdict.split("-")[0] in ("launch", "byte", "f32")


def test_bench_step_card_equals_plain(dev):
    """One step of the benchmark's data through the kernel against the
    same step through the plain versions on the card, every field."""
    from somatic_sniper_tpu_torch.models import glfgen as mg
    from somatic_sniper_tpu_torch.utils import mfu

    params = T.ModelParams()
    dtabs = device_tables(T.build_tables(params), dev)
    stacked_h, meta_h = mfu.bench_inputs(4096, 48)
    cbs = ts.packed_column_batches(
        torch.from_numpy(stacked_h.view(np.int32)).to(dev),
        torch.from_numpy(meta_h).to(dev))
    got = ts.call_batch(*cbs, dtabs, params)
    kernel, mg.glfgen32 = mg.glfgen32, gk.glfgen32_plain
    try:
        want = ts.call_batch(*cbs, dtabs, params)
    finally:
        mg.glfgen32 = kernel
    # the class sums are added in another order: the qualities that
    # pass through them may differ by one step, nothing else may
    pm1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
           "somatic_score", "joint_cnsq")
    for name, a, b in zip(got._fields, got, want):
        if a is None:  # no error word at depth 48
            assert b is None, name
            continue
        d = (a.long() - b.long()).abs()
        assert int(d.max()) <= (1 if name in pm1 else 0), name
        assert float((d == 0).float().mean()) >= 0.99, name


def test_entry_on_card_matches_cpu(dev):
    from somatic_sniper_tpu_torch.parallel.dryrun import entry

    fn, args = entry()
    assert args[0].slots.device.type == "cuda"
    gk.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["glfgen"] == 2 and gk.LAUNCHES["score_columns"] == 1
    assert sum(gk.LAUNCHES.values()) == 3
    fn_cpu, args_cpu = entry("cpu")
    want = fn_cpu(*args_cpu)
    for name, a, b in zip(got._fields, got, want):
        if b is None:
            assert a is None, name
        else:
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("prefilter", [True, False])
def test_windowed_records_on_card(dev, prefilter):
    """``fmt=None`` and ``prefilter`` through the windowed driver on the
    card: the records format to the bytes of the ``fmt=`` run; with the
    prefilter off every shared column is scored, most on the card."""
    import io

    from somatic_sniper_tpu_torch.output.formatters import get_formatter
    from somatic_sniper_tpu_torch.output.records import SniperRecord
    from somatic_sniper_tpu_torch.parallel.sharded import call_pair_sharded
    from somatic_sniper_tpu_torch.utils.stats import STATS

    d = DATA / "e2e" / "sim1"
    args = (str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"))
    kw = dict(precision="fast", device=dev, window_size=700,
              prefilter=prefilter)
    lines = list(call_pair_sharded(*args, "vcf", **kw))
    STATS.reset()
    gk.reset_launches()
    recs = list(call_pair_sharded(*args, None, **kw))
    stats = STATS.snapshot()
    assert recs and all(isinstance(r, SniperRecord) for r in recs)
    fh = io.StringIO()
    for r in recs:
        get_formatter("vcf")[1](fh, r)
    assert fh.getvalue().splitlines(keepends=True) == lines
    assert gk.LAUNCHES["glfgen32"] == 2 * stats["slabs_dispatched"] > 0
    if not prefilter:
        scored = sum(stats.get(k, 0) for k in (
            "device_columns", "host_deep_columns"))
        assert scored == stats["columns_scored"] > 20 * len(recs)
        assert stats["device_columns"] > 0.9 * scored


def _card_slab(B, D, seed, dev):
    stacked, meta = random_slab(B, D, seed)
    return (stacked, meta, torch.from_numpy(stacked.view(np.int32)).to(dev),
            torch.from_numpy(meta).to(dev))


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
def test_graphed_step_equals_eager_on_card(dev, D, use_joint):
    """The captured step at every slab depth the dispatcher can pick
    (``parallel.slab.ALLOWED_D``), two input sets back to back: count
    and rows byte-equal to the eager step on the same inputs (the second
    set gives the second answer: no stale static buffer), and a replay
    counts the two glfgen32 launches the eager step makes."""
    from somatic_sniper_tpu_torch.models.step_graph import SlabStepGraph
    from somatic_sniper_tpu_torch.parallel.slab import ALLOWED_D

    assert D in ALLOWED_D
    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = device_tables(T.build_tables(params), dev)
    graphs = SlabStepGraph()
    answers = []
    for seed in (D, D + 1):
        stacked, meta, s, m = _card_slab(4096, D, seed, dev)
        before = dict(gk.LAUNCHES)
        eager = ts.call_batch_packed(s, m, dtabs, params)
        n_e = int(eager.count)
        rows_e = eager.rows[:n_e].cpu().numpy()
        eager_launches = {k: gk.LAUNCHES[k] - before[k] for k in before}
        before = dict(gk.LAUNCHES)
        n, rows = graphs.run(stacked, meta, dtabs, params, dev)
        assert {k: gk.LAUNCHES[k] - before[k] for k in before} == \
            eager_launches
        assert eager_launches["glfgen32"] == 2
        assert eager_launches["score_columns"] == 1
        assert n == n_e > 0
        assert rows.dtype == rows_e.dtype and np.array_equal(rows, rows_e)
        answers.append(rows)
    assert len(graphs.captures()) == 1
    assert not (len(answers[0]) == len(answers[1])
                and np.array_equal(*answers))


def test_slab_path_on_card_replays_the_graph(dev, monkeypatch):
    """A card dispatcher scores its slab through the captured step and
    never the eager one."""
    from somatic_sniper_tpu_torch.models.step_graph import SlabStepGraph
    from somatic_sniper_tpu_torch.parallel import slab

    def eager(*args):
        raise AssertionError("the card ran the eager step")

    graphs = SlabStepGraph()
    monkeypatch.setattr(slab, "STEP_GRAPHS", graphs)
    monkeypatch.setattr(slab, "call_batch_packed", eager)
    params = T.ModelParams(min_somatic_qual=0)
    tabs = T.build_tables(params)
    dtabs = device_tables(tabs, dev)
    disp = slab.TorchSlabDispatcher(lambda: dtabs, tabs, params, None, dev)
    stacked, meta, s, m = _card_slab(2048, 48, 9, dev)
    want = ts.call_batch_packed(s, m, dtabs, params)
    n, rows = disp._dispatch_and_fetch(stacked, meta)
    disp._collector.shutdown()
    assert n == int(want.count) > 0
    assert np.array_equal(rows, want.rows[:n].cpu().numpy())
    assert len(graphs.captures()) == 1


def test_failed_capture_raises_on_card(dev, monkeypatch):
    """A step that reads a value back to the host cannot be captured: the
    capture raises, the slab fails with it, and no eager step runs in
    its place."""
    from somatic_sniper_tpu_torch.models import step_graph as sg
    from somatic_sniper_tpu_torch.parallel import slab

    def reads_back(stacked, meta, dtabs, params):
        res = ts.call_batch_packed(stacked, meta, dtabs, params)
        int(res.count)  # a host read: no capture allows it
        return res

    def eager(*args):
        raise AssertionError("the card ran the eager step")

    graphs = sg.SlabStepGraph()
    monkeypatch.setattr(sg, "call_batch_packed", reads_back)
    monkeypatch.setattr(slab, "STEP_GRAPHS", graphs)
    monkeypatch.setattr(slab, "call_batch_packed", eager)
    params = T.ModelParams()
    tabs = T.build_tables(params)
    dtabs = device_tables(tabs, dev)
    disp = slab.TorchSlabDispatcher(lambda: dtabs, tabs, params, None, dev)
    stacked, meta = random_slab(1024, 16, 2)
    with pytest.raises(RuntimeError):
        disp._dispatch_and_fetch(stacked, meta)
    disp._collector.shutdown()
    assert graphs.captures() == {}
    torch.cuda.synchronize()  # the card is still usable


def _card_batch(b0, D, seed, packed16):
    """A PairedBatch of ``b0`` columns, its ref16, and the upload padded
    to its bucket as runner.submit_call_batch pads it."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch

    stacked, meta = random_stacked(b0, D, seed, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    batch = PairedBatch(keys=np.arange(b0, dtype=np.int64), ref16=meta[2],
                        tumor=stacked[0], normal=stacked[1],
                        n_tumor=meta[0], n_normal=meta[1], **extra)
    B = runner._b_bucket(b0)
    padded = (np.stack([runner._pad_b(x, B) for x in stacked]),
              np.stack([runner._pad_b(x, B) for x in meta]))
    return batch, meta[2], padded


@pytest.mark.parametrize("packed16,precision,b0", [
    (False, "fast", 65536), (True, "fast", 65536), (False, "exact", 65536),
    (False, "fast", 5000),
], ids=["u32-fast", "u16-fast", "u32-exact", "u32-fast-tail"])
def test_graphed_batch_step_equals_eager_on_card(dev, monkeypatch, packed16,
                                                 precision, b0):
    """Three batches of one key through runner.submit_call_batch, left
    pending: the first eager, the second captured, the third replayed;
    each one's count and rows byte-equal to the eager step on the same
    padded upload, and the same kernel launches (a tail of 5000 columns
    pads to 6144)."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.models import step_graph as sg
    from somatic_sniper_tpu_torch.utils.stats import STATS

    graphs = sg.SlabStepGraph()
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    D = 40
    params = T.ModelParams(min_somatic_qual=0)
    dtabs = device_tables(T.build_tables(params), dev, precision)
    STATS.reset()
    pending, eager_launches = [], []
    for seed in (1, 2, 3):
        batch, ref16, padded = _card_batch(b0, D, seed, packed16)
        before = dict(gk.LAUNCHES)
        res = runner.submit_call_batch(batch, ref16, dtabs, dev,
                                       precision=precision)
        pending.append((res, {k: gk.LAUNCHES[k] - before[k] for k in before},
                        padded))
    snap = STATS.snapshot()
    assert (snap["batches_eager_first"], snap["batch_captures"],
            snap["batches_graphed"]) == (1, 1, 2)
    B = runner._b_bucket(b0)
    answers = []
    for res, launches, (stacked, meta) in pending:
        s = torch.from_numpy(stacked if packed16
                             else stacked.view(np.int32)).to(dev)
        before = dict(gk.LAUNCHES)
        want = ts.call_batch_stacked(
            s, torch.from_numpy(meta).to(dev), dtabs, params,
            packed16=packed16, max_emit=min(runner.MAX_EMIT, B),
            precision=precision)
        eager_launches.append({k: gk.LAUNCHES[k] - before[k]
                               for k in before})
        n, n_e = int(res.count), int(want.count)
        assert n == n_e > 0
        rows, rows_e = res.rows.cpu().numpy(), want.rows.cpu().numpy()
        assert rows.shape == rows_e.shape == (min(runner.MAX_EMIT, B), 17)
        assert rows[:n].tobytes() == rows_e[:n].tobytes()
        answers.append(rows[:n].tobytes())
        assert launches == eager_launches[-1]
    assert len(set(answers)) == 3
    fused = {(False, "fast"): "glfgen", (True, "fast"): "glfgen16"}
    assert eager_launches[0] == {
        k: 2 if k == fused.get((packed16, precision))
        else 1 if k == "score_columns" else 0
        for k in gk.LAUNCHES}
    assert len(graphs.captures()) == 1


def test_failed_batch_capture_raises_on_card(dev, monkeypatch):
    """A batch step that reads a value back to the host cannot be
    captured: the key's second batch raises, and no eager step scores
    it in its place."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.models import step_graph as sg

    def reads_back(*args, **kwargs):
        res = ts.call_batch_stacked(*args, **kwargs)
        int(res.count)  # a host read: no capture allows it
        return res

    graphs = sg.SlabStepGraph()
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    monkeypatch.setattr(sg, "call_batch_stacked", reads_back)
    params = T.ModelParams()
    dtabs = device_tables(T.build_tables(params), dev)
    batch, ref16, _ = _card_batch(1000, 24, 4, True)
    runner.submit_call_batch(batch, ref16, dtabs, dev)
    before = dict(gk.LAUNCHES)
    with pytest.raises(RuntimeError):
        runner.submit_call_batch(batch, ref16, dtabs, dev)
    assert graphs.captures() == {}
    assert dict(gk.LAUNCHES) == before
    torch.cuda.synchronize()  # the card is still usable


def test_deep_fast_batch_error_word_raises_at_collect_on_card(dev,
                                                             monkeypatch):
    """A fast batch of depth 300 replays its key's graph; a class count
    pushed outside the tables (a device tensor added to the rescaled
    counts, which the graph reads at its address) raises the
    stand-alone assembly's ValueError at collect_pending, never at
    submit."""
    import re

    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.models import glfgen as mg
    from somatic_sniper_tpu_torch.models import step_graph as sg

    graphs = sg.SlabStepGraph()
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    bad = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    real = mg.rescale_counts
    monkeypatch.setattr(mg, "rescale_counts", lambda c: real(c) + bad)
    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    message = re.escape(gk._count_error(256))
    pending = []
    for seed in (1, 2, 3):
        batch, ref16, _ = _card_batch(1000, 300, seed, False)
        if seed == 3:
            bad[0, 1] = 1000
        pending.append((batch, ref16, runner.submit_call_batch(
            batch, ref16, dtabs, dev)))
    assert len(graphs.captures()) == 1
    assert [int(p[2].err) for p in pending] == [0, 0, 1]
    with pytest.raises(ValueError, match=message):
        runner.collect_pending(pending, None, None, None, dtabs, dev)
    torch.cuda.synchronize()  # the card is still usable


# -- score_columns: the scoring step after glfgen in one kernel -------------

def _score_args(cols, ref16, dtabs, params, dq, dev, offset=0):
    """score_columns' arguments on the card from ``score_inputs``; the
    lanes start ``offset`` words into their allocation."""
    t = {w: {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                 else v).to(dev) for k, v in c.items()}
         for w, c in cols.items()}
    tu, no = t["tumor"], t["normal"]
    for c in (tu, no):
        B, D = c["slots"].shape
        c["slots"] = torch.empty(B * D + offset, dtype=torch.int32,
                                 device=dev)[offset:].view(B, D).copy_(
                                     c["slots"])
    lanes = (tu["slots"], tu["nk"], no["slots"], no["nk"]) if dq else None
    return (tu["lk"], no["lk"], tu["depth"], no["depth"], tu["n"], no["n"],
            torch.from_numpy(ref16).to(dev), dtabs.solo_prior,
            dtabs.joint_prior, dtabs.q_r_int, params, lanes)


def _check_score_columns(dev, B, D, use_joint, offset=0):
    """The kernel against score_columns_plain on the same card inputs,
    bit for bit: emit, the 16 fields and both dqstats rows, with the
    dqstats and without (so both instances of the mode), every gate flag
    each way, tie-heavy and full likelihood ranges; two launches give the
    same bits, and the padding columns never emit."""
    from somatic_sniper_tpu_torch.ops import score_kernels as sk

    dtabs = device_tables(
        T.build_tables(T.ModelParams(use_joint_priors=use_joint)), dev)
    for hi in (4, 256):
        cols, ref16 = score_inputs(B, D, B + D + hi, hi)
        for loh, gor in ((True, True), (False, True), (True, False),
                         (False, False)):
            params = T.ModelParams(use_joint_priors=use_joint,
                                   min_somatic_qual=15, include_loh=loh,
                                   include_gor=gor)
            for dq in (True, False):
                args = _score_args(cols, ref16, dtabs, params, dq, dev,
                                   offset)
                before = gk.LAUNCHES["score_columns"]
                got, again = sk.score_columns(*args), sk.score_columns(*args)
                want = sk.score_columns_plain(*args)
                torch.cuda.synchronize()
                assert gk.LAUNCHES["score_columns"] == before + 2
                for name, a, a2, b in zip(got._fields, got, again, want):
                    if b is None:
                        assert a is None and a2 is None, name
                        continue
                    assert a.dtype == b.dtype and a.shape == b.shape, name
                    assert torch.equal(a, b), (name, hi, loh, gor, dq)
                    assert torch.equal(a, a2), name
                if B >= 16:
                    assert not got.emit[-SCORE_PAD:].any()


# score_columns.cu's kCols: the columns (threads) of a block
SCORE_BLOCK = 64


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [1, 47, 48, 80, 128, 255])
@pytest.mark.parametrize("B", [1, 33, SCORE_BLOCK - 1, SCORE_BLOCK,
                               SCORE_BLOCK + 1, 2 * SCORE_BLOCK + 1, 8192,
                               65536])
def test_score_columns_matches_plain_on_card(dev, B, D, use_joint):
    """The kernel against its plain version (``_check_score_columns``),
    a thread a column in blocks of SCORE_BLOCK: B at and around the block
    size and at the slab's and the batch's sizes, D odd and even (the
    skewed row walk) to 255 (the largest copy to shared memory; at 80
    the copy and the static shared memory pass 48 KB together, not
    alone); all four instances."""
    _check_score_columns(dev, B, D, use_joint)


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [1, 3, 47, 48])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_score_columns_unaligned_lanes_on_card(dev, offset, D, use_joint):
    """Lanes that start 1-3 words past a 16-byte boundary: each block's
    region is copied as its aligned middle and the words on either
    side, the whole region by threads where it spans no aligned chunk."""
    for B in (1, SCORE_BLOCK + 1, 2 * SCORE_BLOCK + 2):
        _check_score_columns(dev, B, D, use_joint, offset)


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [256, 600, 384, 512, 1024])
def test_score_columns_direct_rows_on_card(dev, D, use_joint):
    """Rows read from device memory by their thread: deeper than the copy
    to shared memory takes (256, and 600, whose packed sums flush three
    chunks of 255 lanes; 384, 512 and 1024, slab tiers above 255, with
    the dqstats over all their lanes)."""
    for B in (SCORE_BLOCK + 1, 1000):
        _check_score_columns(dev, B, D, use_joint)


def test_score_columns_empty_batch_on_card(dev):
    """B == 0 launches nothing and returns empty outputs."""
    from somatic_sniper_tpu_torch.ops import score_kernels as sk

    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    cols, ref16 = score_inputs(16, 8, 1, 10)
    cols = {w: {k: v[:0] for k, v in c.items()} for w, c in cols.items()}
    before = dict(gk.LAUNCHES)
    got = sk.score_columns(*_score_args(cols, ref16[:0], dtabs,
                                        T.ModelParams(), True, dev))
    assert dict(gk.LAUNCHES) == before
    assert got.fields.shape == (0, 16) and got.tumor_dq.shape == (0, 18)


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("step", ["packed", "u32-fast", "u16-fast",
                                  "u32-exact"])
def test_step_rows_kernel_equal_plain_on_card(dev, monkeypatch, step,
                                              use_joint):
    """call_batch_packed and call_batch_stacked (both encodings, both
    precisions) through score_columns against the same step with its
    plain version in its place: count and rows byte-equal, and the full
    CallResult of a batch field for field."""
    from somatic_sniper_tpu_torch.ops import score_kernels as sk

    enc, precision = (step.split("-") + ["fast"])[:2]
    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = device_tables(T.build_tables(params), dev, precision)
    if enc == "packed":
        B, D = 8192, 48
        stacked, meta = random_slab(B, D, 11 + use_joint)
        s = torch.from_numpy(stacked.view(np.int32)).to(dev)

        def run():
            return (ts.call_batch_packed(s, m, dtabs, params),)
    else:
        B, D = 4096, 40
        packed16 = enc == "u16"
        stacked, meta = random_stacked(B, D, 13 + use_joint, packed16)
        s = torch.from_numpy(stacked if packed16
                             else stacked.view(np.int32)).to(dev)

        def run():
            return tuple(ts.call_batch_stacked(
                s, m, dtabs, params, packed16=packed16, max_emit=B,
                compact=compact, precision=precision)
                for compact in (True, False))
    m = torch.from_numpy(meta).to(dev)
    gk.reset_launches()
    got = run()
    assert gk.LAUNCHES["score_columns"] == len(got)
    monkeypatch.setattr(ts, "score_columns", sk.score_columns_plain)
    want = run()
    torch.cuda.synchronize()
    n = int(got[0].count)
    assert n == int(want[0].count) > 0
    assert (got[0].rows[:n].cpu().numpy().tobytes()
            == want[0].rows[:n].cpu().numpy().tobytes())
    if len(got) > 1:
        for name, a, b in zip(got[1]._fields, got[1], want[1]):
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a, b), name


@pytest.mark.parametrize("use_joint", [False, True])
def test_eager_slab_step_device_operations_on_card(dev, use_joint):
    """An eager slab step at (8192, 48) queues under 40 device operations
    (torch ops that compute, and the kernels: glfgen32 twice and
    score_columns once), where the torch ops of consensus, score, gates
    and dqstats queued ~1,230 (~2,500 with joint priors)."""
    from somatic_sniper_tpu_torch.utils.mfu import count_step_ops

    params = T.ModelParams(use_joint_priors=use_joint)
    dtabs = device_tables(T.build_tables(params), dev)
    _, _, s, m = _card_slab(8192, 48, 5, dev)
    ts.call_batch_packed(s, m, dtabs, params)  # warm: the table cuts
    torch.cuda.synchronize()
    before = dict(gk.LAUNCHES)
    n_ops = count_step_ops(lambda: ts.call_batch_packed(s, m, dtabs, params))
    launched = {k: gk.LAUNCHES[k] - before[k] for k in before
                if gk.LAUNCHES[k] != before[k]}
    assert launched == {"glfgen32": 2, "score_columns": 1}
    assert n_ops + sum(launched.values()) < 40


# -- slabs deeper than 255 ---------------------------------------------------

@pytest.mark.parametrize("D", [384, 512, 1024])
def test_deep_glfgen_equals_plain_on_card(dev, D):
    """The deep slab step's glfgen on the card (``accumulate`` with
    ``n_keep`` as the depth, the c_tot > 255 rescale, ``assembly10``):
    counts, rms and read counts equal the plain accumulate's, the class
    sums agree to f32 summation order, and the ten likelihoods equal the
    plain rescale and assembly over the kernel's sums bit for bit, at
    columns 256-D deep, half of them with likelihoods strictly between 0
    and 255; the error word stays 0; one accumulate and one assembly10
    launch a sample."""
    from somatic_sniper_tpu_torch.models import glfgen as mg

    dtabs = device_tables(T.build_tables(T.ModelParams()), dev)
    slots, nk, ref16 = deep_raw32(1024, D, D)
    s, n, r = (torch.from_numpy(a).to(dev)
               for a in (slots.view(np.int32), nk, ref16))
    cols = mg.ColumnBatch(slots=s, depth=n, ref16=r, n_keep=n)
    before = dict(gk.LAUNCHES)
    lk, n_out, err = mg.glfgen_lk(cols, dtabs, 60)
    launched = {k: gk.LAUNCHES[k] - before[k] for k in before
                if gk.LAUNCHES[k] != before[k]}
    assert launched == {"accumulate": 1, "assembly10": 1}
    k = gk.accumulate(s, n, r, dtabs.fk_weights, 60)
    p = gk.accumulate_plain(s, n, r, dtabs.fk_weights, 60)
    for a, b in zip(k[2:], p[2:]):
        assert torch.equal(a, b)
    _assert_sums(k, p, D)
    want, _ = gk.assembly10_plain(k[0], k[1], mg.rescale_counts(k[2]), n,
                                  *dtabs.assembly_tables(D))
    torch.cuda.synchronize()
    assert int(err[0]) == 0 and torch.equal(n_out, n)
    assert torch.equal(lk, want)
    assert int(((lk > 0) & (lk < 255)).any(dim=1).sum()) >= 256


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("D", [255, 384, 512, 1024])
def test_graphed_deep_step_equals_eager_on_card(dev, D, use_joint):
    """The captured step at the slab tiers from 255 up (the wide
    metadata and the rescale above it), two input sets back to back:
    count and rows byte-equal to the eager step, and a replay counts the
    eager step's launches."""
    from somatic_sniper_tpu_torch.models.step_graph import SlabStepGraph
    from somatic_sniper_tpu_torch.parallel.slab import ALLOWED_D

    assert D in ALLOWED_D
    want_launches = ({"glfgen32": 2, "score_columns": 1} if D <= 255 else
                     {"accumulate": 2, "assembly10": 2, "score_columns": 1})
    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = device_tables(T.build_tables(params), dev)
    graphs = SlabStepGraph()
    answers = []
    for seed in (D, D + 1):
        stacked, meta, s, m = _card_slab(4096, D, seed, dev)
        before = dict(gk.LAUNCHES)
        eager = ts.call_batch_packed(s, m, dtabs, params)
        n_e = int(eager.count)
        assert int(eager.err) == 0
        rows_e = eager.rows[:n_e].cpu().numpy()
        eager_launches = {k: gk.LAUNCHES[k] - before[k] for k in before
                          if gk.LAUNCHES[k] != before[k]}
        before = dict(gk.LAUNCHES)
        n, rows = graphs.run(stacked, meta, dtabs, params, dev)
        assert {k: gk.LAUNCHES[k] - before[k] for k in before
                if gk.LAUNCHES[k] != before[k]} == eager_launches
        assert eager_launches == want_launches
        assert n == n_e > 0
        assert rows.dtype == rows_e.dtype and np.array_equal(rows, rows_e)
        answers.append(rows)
    assert len(graphs.captures()) == 1
    assert not (len(answers[0]) == len(answers[1])
                and np.array_equal(*answers))


@pytest.mark.parametrize("use_joint", [False, True])
def test_deep_step_rows_kernel_equal_plain_on_card(dev, monkeypatch,
                                                   use_joint):
    """call_batch_packed at (8192, 384) through score_columns against the
    same step with its plain version in its place: count and rows,
    the dqstats over every lane among them, byte-equal."""
    from somatic_sniper_tpu_torch.ops import score_kernels as sk

    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = device_tables(T.build_tables(params), dev)
    _, _, s, m = _card_slab(8192, 384, 21 + use_joint, dev)
    got = ts.call_batch_packed(s, m, dtabs, params)
    monkeypatch.setattr(ts, "score_columns", sk.score_columns_plain)
    want = ts.call_batch_packed(s, m, dtabs, params)
    torch.cuda.synchronize()
    n = int(got.count)
    assert n == int(want.count) > 0
    assert got.rows.shape[1] == 1 + 16 + 36
    assert (got.rows[:n].cpu().numpy().tobytes()
            == want.rows[:n].cpu().numpy().tobytes())


def test_deep_slab_error_word_raises_at_fetch_on_card(dev, monkeypatch):
    """A deep slab replays its captured step; a class count pushed outside
    the tables (a device tensor added to the rescaled counts, which the
    graph reads at its address) raises the stand-alone assembly's
    ValueError at the step's fetch, and the card stays usable."""
    import re

    from somatic_sniper_tpu_torch.models import glfgen as mg
    from somatic_sniper_tpu_torch.models.step_graph import SlabStepGraph

    bad = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    real = mg.rescale_counts
    monkeypatch.setattr(mg, "rescale_counts", lambda c: real(c) + bad)
    params = T.ModelParams()
    dtabs = device_tables(T.build_tables(params), dev)
    graphs = SlabStepGraph()
    stacked, meta, _, _ = _card_slab(1024, 384, 4, dev)
    n, _ = graphs.run(stacked, meta, dtabs, params, dev)
    bad[0, 3] = 1000
    with pytest.raises(ValueError, match=re.escape(gk._count_error(256))):
        graphs.run(stacked, meta, dtabs, params, dev)
    bad.zero_()
    assert graphs.run(stacked, meta, dtabs, params, dev)[0] == n
    assert len(graphs.captures()) == 1


def test_windowed_300x_pair_on_card(dev, tmp_path, monkeypatch):
    """A 2 x 20 kb pair at 300x through the windowed driver on the card:
    every plan survivor in slabs of a tier above 255, each slab replayed
    from its captured step, none on the host's exact scorer, and the
    records within the fast contract of the exact run."""
    from somatic_sniper_tpu_torch.parallel.sharded import call_pair_windows
    from somatic_sniper_tpu_torch.utils.simulate import (SimConfig,
                                                         simulate_pair_fast)
    from somatic_sniper_tpu_torch.utils.stats import STATS

    monkeypatch.delenv("SNIPER_SLAB_D", raising=False)
    simulate_pair_fast(tmp_path, SimConfig(
        n_contigs=2, contig_len=20_000, read_len=150, mean_depth=300.0,
        somatic_rate=1e-3, germline_rate=1e-3, seed=5))
    args = (str(tmp_path / "tumor.bam"), str(tmp_path / "normal.bam"),
            str(tmp_path / "ref.fa"))

    def lines(precision):
        return [ln for _, _, ls in call_pair_windows(
            *args, precision=precision, fmt="vcf", window_size=10_000,
            device=dev) for ln in ls]

    s0 = STATS.snapshot()
    fast = lines("fast")
    s1 = STATS.snapshot()
    d = {k: s1.get(k, 0) - s0.get(k, 0) for k in s1}
    assert d.get("host_deep_columns", 0) == 0
    assert d["device_columns"] == d["device_columns_deep"] == \
        d["columns_scored"] > 30_000
    assert d["slabs_graphed"] == d["slabs_dispatched"] == \
        d["slabs_at_depth_384"] > 0
    diff_records(fast, lines("exact"), "vcf")
