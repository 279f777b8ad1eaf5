"""Slabs deeper than 255 on the CPU, through the plain torch versions.

The slab dispatcher's tiers above 255 (``parallel/slab.ALLOWED_D``), the
packed metadata's wide layout (``models/somatic.packed_column_batches``,
native ``slab_fill_pair``), the deep slab step (the accumulate, the
c_tot > 255 rescale and the assembly, ``models/glfgen._glfgen_fast``),
its error word read at fetch, and a windowed fast run of a small 300x
pair.  The deep step is held bit for bit to the port's batch route over
the same reads and to the JAX package's fast glfgen; the card's kernels
are held to these plain versions in tests/test_torch_cuda.py.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (deep_raw32,  # noqa: E402
                                   eager_stand_in, f32_tables,
                                   pack_slab_meta, random_slab)

from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu.models.glfgen import ColumnBatch as JCB  # noqa: E402
from somatic_sniper_tpu.models.glfgen import glfgen_batch  # noqa: E402
from somatic_sniper_tpu_torch.io.native_api import (  # noqa: E402
    SLAB_MAX_D, slab_fill_pair)
from somatic_sniper_tpu_torch.models import glfgen as mg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import step_graph as sg  # noqa: E402
from somatic_sniper_tpu_torch.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.parallel import slab as slab_mod  # noqa: E402
from somatic_sniper_tpu_torch.parallel.sharded import (  # noqa: E402
    call_pair_windows)
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")


# -- depth tiers --------------------------------------------------------------

def _pair_dmax(depth: float, n: int, seed: int) -> np.ndarray:
    """max(d_t, d_n) of ``n`` columns of a pair at ``depth`` a sample."""
    rng = np.random.default_rng(seed)
    return rng.poisson(depth, (2, n)).max(axis=0)


def test_choose_d_picks_a_deep_tier_at_300x_and_48_at_30x(monkeypatch):
    monkeypatch.delenv("SNIPER_SLAB_D", raising=False)
    assert 255 in slab_mod.ALLOWED_D and slab_mod.ALLOWED_D[-1] >= 512
    deep = _pair_dmax(300.0, 200_000, 1)
    d = slab_mod.choose_d(deep)
    assert d == 384 and d > 255
    assert (deep <= d).mean() >= slab_mod.COVER_TARGET
    assert slab_mod.choose_d(_pair_dmax(30.0, 200_000, 2)) == 48
    # the histogram sees every tier, and past the deepest one
    assert slab_mod.choose_d(np.full(100, 200)) == 255
    assert slab_mod.choose_d(np.full(100, 256)) == 384
    assert slab_mod.choose_d(np.full(100, 500)) == 512
    assert slab_mod.choose_d(np.full(100, 700)) == 768
    assert slab_mod.choose_d(np.full(100, 1000)) == 1024
    assert slab_mod.choose_d(np.full(100, 5000)) == slab_mod.ALLOWED_D[-1]
    hist = np.bincount(np.minimum(deep, slab_mod.HIST_TOP),
                       minlength=slab_mod.HIST_TOP + 1)
    assert slab_mod.choose_d_hist(hist) == 384


def test_choose_d_covers_a_700x_tumor(monkeypatch):
    """A capture panel's 700x tumor beside a 300x normal lands on a tier
    above 512 that covers COVER_TARGET of its columns; the rest go to the
    host, as at every tier."""
    monkeypatch.delenv("SNIPER_SLAB_D", raising=False)
    rng = np.random.default_rng(4)
    dmax = np.maximum(rng.poisson(700.0, 200_000),
                      rng.poisson(300.0, 200_000))
    d = slab_mod.choose_d(dmax)
    assert d in (768, 1024) and d <= slab_mod.ALLOWED_D[-1]
    assert (dmax <= d).mean() >= slab_mod.COVER_TARGET


def test_slab_d_override_reaches_the_wide_layout(monkeypatch):
    monkeypatch.setenv("SNIPER_SLAB_D", "300")
    assert slab_mod.choose_d(np.full(10, 30)) == 300
    monkeypatch.setenv("SNIPER_SLAB_D", str(10**6))
    assert slab_mod.choose_d(np.full(10, 30)) == ts.MAX_D


def test_mid_run_upgrade_reaches_the_deep_tiers(monkeypatch, capfd):
    """A depth pinned from shallow windows is upgraded once to the tier
    the accumulated histogram asks for, above 255 where a 300x region
    follows, and the warning names the deepest tier."""
    monkeypatch.delenv("SNIPER_SLAB_D", raising=False)
    params = T.ModelParams()
    disp = slab_mod.TorchSlabDispatcher(None, None, params, None, CPU)
    try:
        disp.D = 48
        deep = _pair_dmax(300.0, 3 * slab_mod.D_SAMPLE_COLS, 3)
        disp._dhist += np.bincount(np.minimum(deep, slab_mod.HIST_TOP),
                                   minlength=slab_mod.HIST_TOP + 1)
        disp._total_cols = disp._deep_cols = len(deep)
        assert disp._maybe_upgrade_d() and disp.D == 384
        assert not disp._maybe_upgrade_d() and disp.D == 384
    finally:
        disp._collector.shutdown()
    err = capfd.readouterr().err
    assert "the deepest slab tier is 1024" in err
    assert "upgrading slab depth 48 -> 384" in err


# -- the wide metadata --------------------------------------------------------

@pytest.mark.parametrize("D", [256, 384, 512, 1024, ts.MAX_D])
def test_wide_metadata_round_trips(D):
    """Depths and kept counts from 256 up to the bound come back from
    the packed metadata of a slab deeper than 255."""
    vals = np.unique(np.array([256, 300, 383, 384, 511, 512, 767, 1023,
                               D - 1, D]))
    vals = vals[(vals >= 256) & (vals <= D)]
    d_t, d_n = vals, vals[::-1]
    nk_t, nk_n = vals[::-1] - 1, vals
    ref16 = np.resize(np.array([1, 2, 4, 8, 15]), len(vals))
    meta = pack_slab_meta(ref16, d_t, d_n, nk_t, nk_n, D)
    stacked = torch.zeros((2, len(vals), D), dtype=torch.int32)
    t, n = ts.packed_column_batches(stacked, torch.from_numpy(meta))
    for got, want in ((t.depth, d_t), (n.depth, d_n), (t.n_keep, nk_t),
                      (n.n_keep, nk_n), (t.ref16, ref16), (n.ref16, ref16)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_narrow_metadata_unchanged_to_255():
    """To D = 255 the metadata keeps its byte layout (the JAX package's
    and the native fill's): a depth of 255 and a count of 254."""
    meta = pack_slab_meta([4], [255], [7], [254], [3], 255)
    assert int(meta[1, 0]) == 0
    assert (int(meta[2, 0]) & 0xFFFFFFFF) == \
        255 | 7 << 8 | 254 << 16 | 3 << 24
    t, n = ts.packed_column_batches(
        torch.zeros((2, 1, 255), dtype=torch.int32), torch.from_numpy(meta))
    assert (int(t.depth), int(n.depth), int(t.n_keep), int(n.n_keep)) == \
        (255, 7, 254, 3)


def test_metadata_past_the_bound_raises():
    with pytest.raises(ValueError, match="D <= 65535"):
        ts.packed_column_batches(
            torch.zeros((2, 1, ts.MAX_D + 1), dtype=torch.int32),
            torch.zeros((3, 1), dtype=torch.int32))
    assert SLAB_MAX_D == ts.MAX_D
    z = np.zeros(1, np.int64)
    with pytest.raises(ValueError, match="slab depth"):
        slab_fill_pair(None, None, z, z, z, z, z, SLAB_MAX_D + 1, 60,
                       *(np.zeros(1, np.uint32),) * 2,
                       *(np.zeros(1, np.int32),) * 3)


# -- the deep slab step -------------------------------------------------------

def _tables():
    tabs = JT.build_tables(JT.ModelParams())
    return tabs, T.device_tables(T.build_tables(T.ModelParams()), CPU)


@pytest.mark.parametrize("D,seed", [(384, 1), (600, 2)])
def test_deep_step_glfgen_equals_batch_route_and_jax(D, seed):
    """The deep slab step's ten likelihoods and counts (raw kept-only
    lanes, ``accumulate`` with ``n_keep`` as the depth) equal the port's
    batch route over the same reads as full u32 words and the JAX
    package's fast glfgen bit for bit; columns whose likelihoods lie
    strictly between 0 and 255 are among them, and rounding the plain
    class sums to bfloat16 moves at least one of their likelihoods."""
    B = 64
    slots, nk, ref16 = deep_raw32(B, D, seed)
    jtabs, dtabs = _tables()
    s = torch.from_numpy(slots.view(np.int32))
    nk_t, r = torch.from_numpy(nk), torch.from_numpy(ref16)
    slab = mg.ColumnBatch(slots=s, depth=nk_t, ref16=r, n_keep=nk_t)
    batch = mg.ColumnBatch(slots=s, depth=nk_t, ref16=r)
    got = mg.glfgen_batch(slab, dtabs, 60)
    via_batch = mg.glfgen_batch(batch, dtabs, 60)
    lk, n, err = mg.glfgen_lk(slab, dtabs, 60)
    assert int(err[0]) == 0 and int(got.err[0]) == 0
    for a, b in zip(got, via_batch):
        assert torch.equal(a, b)
    assert torch.equal(lk, got.lk) and torch.equal(n, nk_t)
    fk, coef, lhet = f32_tables(jtabs)
    want = glfgen_batch(JCB(slots=jnp.asarray(slots), depth=jnp.asarray(nk),
                            ref16=jnp.asarray(ref16)),
                        fk, coef, lhet, precision="fast", backend="xla")
    np.testing.assert_array_equal(got.lk.numpy(), np.asarray(want.lk))
    np.testing.assert_array_equal(got.min_lk.numpy(), np.asarray(want.min_lk))
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.rms_mapq.numpy(),
                                  np.asarray(want.rms_mapq))
    # every column passes 255 counted reads: all take the rescale
    e, f, c, _, _ = gk.accumulate(s, nk_t, r, dtabs.fk_weights, 60)
    assert int(c.sum(dim=1).min()) > 255
    mid = ((got.lk > 0) & (got.lk < 255)).sum(dim=1) >= 2
    assert int(mid.sum()) >= B // 4, "too few columns in the open range"
    bf = [x.to(torch.bfloat16).to(torch.float32) for x in (e, f)]
    lk_bf, _, _ = gk.assembly10_flagged(*bf, mg.rescale_counts(c), nk_t,
                                        *dtabs.assembly_tables(D))
    assert bool((lk_bf != got.lk)[mid].any())


@pytest.mark.parametrize("use_joint", [False, True])
def test_deep_slab_rows_equal_the_batch_route(use_joint):
    """The slab step at D = 384 (wide metadata, the rescale on the
    device path) gives the rows of the batch step over the same reads as
    full u32 words: the same count, columns and 16 fields, and the 36
    dqstats columns beside them."""
    B, D = 256, 384
    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    s_t, nk_t, ref16 = deep_raw32(B, D, 10)
    s_n, nk_n, _ = deep_raw32(B, D, 11)
    stacked = np.stack([s_t, s_n])
    meta = pack_slab_meta(ref16, nk_t, nk_n, nk_t, nk_n, D)
    slab = ts.call_batch_packed(torch.from_numpy(stacked.view(np.int32)),
                                torch.from_numpy(meta), dtabs, params)
    batch = ts.call_batch_stacked(
        torch.from_numpy(stacked.view(np.int32)),
        torch.from_numpy(np.stack([nk_t, nk_n, ref16]).astype(np.int32)),
        dtabs, params, packed16=False, max_emit=B)
    n = int(slab.count)
    assert n == int(batch.count) > B // 8
    assert int(slab.err) == 0 and int(batch.err) == 0
    rows, rows_b = slab.rows[:n].numpy(), batch.rows[:n].numpy()
    assert rows.shape[1] == 1 + 16 + 36
    np.testing.assert_array_equal(rows[:, :17], rows_b)
    # both samples' dqstats came back with the rows (the windowed run
    # below holds their values to the host's)
    assert (rows[:, 17:35] != 0).any() and (rows[:, 35:] != 0).any()


def _poisoned(monkeypatch, bad):
    real = mg.rescale_counts
    monkeypatch.setattr(mg, "rescale_counts", lambda c: real(c) + bad)


def test_deep_slab_error_word_raises_at_fetch(monkeypatch):
    """A class count pushed outside the tables of a deep slab: the
    captured step's fetch (an eager stand-in for the replay) and the
    dispatcher's eager step raise the stand-alone assembly's ValueError,
    and a sound slab before it gives its rows."""
    import re

    bad = torch.zeros((1, 4), dtype=torch.int32)
    _poisoned(monkeypatch, bad)
    params = T.ModelParams()
    tabs = T.build_tables(params)
    dtabs = T.device_tables(tabs, CPU)
    message = re.escape(gk._count_error(256))
    graphs = sg.SlabStepGraph(capture=eager_stand_in, device_types=("cpu",))
    stacked, meta = random_slab(64, 300, 3)
    n, _ = graphs.run(stacked, meta, dtabs, params, CPU)
    disp = slab_mod.TorchSlabDispatcher(lambda: dtabs, tabs, params, None,
                                        CPU)
    try:
        assert disp._dispatch_and_fetch(stacked, meta)[0] == n
        bad[0, 2] = 1000
        with pytest.raises(ValueError, match=message):
            graphs.run(stacked, meta, dtabs, params, CPU)
        with pytest.raises(ValueError, match=message):
            disp._dispatch_and_fetch(stacked, meta)
    finally:
        disp._collector.shutdown()


# -- a windowed fast run of a 300x pair ---------------------------------------

@pytest.fixture(scope="module")
def deep_pair(tmp_path_factory) -> Path:
    from somatic_sniper_tpu_torch.utils.simulate import (SimConfig,
                                                         simulate_pair_fast)

    d = tmp_path_factory.mktemp("deep300")
    simulate_pair_fast(d, SimConfig(n_contigs=2, contig_len=20_000,
                                    read_len=150, mean_depth=300.0,
                                    somatic_rate=1e-3, germline_rate=1e-3,
                                    seed=5))
    return d


def _windowed(d: Path, precision: str) -> list:
    out = []
    for _wi, _w, lines in call_pair_windows(
            str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
            precision=precision, fmt="vcf", window_size=10_000,
            device="cpu"):
        out.extend(lines)
    return out


def test_windowed_300x_pair_scores_every_survivor_in_deep_slabs(
        monkeypatch, deep_pair):
    """Every plan survivor of a 2 x 20 kb pair at 300x goes into slabs of
    a tier above 255 (none to the host's exact scorer), and the records
    meet the fast contract against the port's exact run."""
    monkeypatch.delenv("SNIPER_SLAB_D", raising=False)
    s0 = STATS.snapshot()
    fast = _windowed(deep_pair, "fast")
    s1 = STATS.snapshot()
    d = {k: s1.get(k, 0) - s0.get(k, 0) for k in s1}
    assert d.get("host_deep_columns", 0) == 0
    assert d["columns_scored"] > 30_000
    assert d["device_columns"] == d["device_columns_deep"] == \
        d["columns_scored"]
    assert d["slabs_at_depth_384"] == d["slabs_dispatched"] > 0
    assert d["slab_bytes_uploaded"] == d["slabs_dispatched"] * (
        2 * slab_mod.slab_b() * 384 * 4 + 3 * slab_mod.slab_b() * 4)
    exact = _windowed(deep_pair, "exact")
    assert sum(not ln.startswith("#") for ln in exact) > 10
    diff_records(fast, exact, "vcf")
