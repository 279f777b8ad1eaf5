"""The torch port's batch path (u16 and full-u32 column batches) against
the JAX package.

``call_batch_stacked`` is held to the JAX function on the same stacked
upload: calls, statuses, depths and emission equal; the qualities and
scores that pass through f32 class sums (summed in another order) within
+/-1, and at least 99% of rows identical.  End to end, the whole-file
CLI with the native library switched off (pure-Python decode, u16
batches) meets the fast contract against the goldens and the JAX
package's run of the same route; the windowed driver's windows that
cannot plan give the same bytes as the slab path.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (f32_tables, filtered_lines,  # noqa: E402
                                   port_params, random_stacked)

from somatic_sniper_tpu import runner as jrunner  # noqa: E402
from somatic_sniper_tpu.io import native_api as jnative_api  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.cli.main import main  # noqa: E402
from somatic_sniper_tpu_torch.io import native_api  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402
from somatic_sniper_tpu_torch.utils.contract import diff_records  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")
PM1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
       "somatic_score", "joint_cnsq")


def _stacked_both(B, D, seed, packed16, use_joint, compact):
    stacked, meta = random_stacked(B, D, seed, packed16)
    params = T.ModelParams(use_joint_priors=use_joint,
                           somatic_mutation_rate=0.001, min_somatic_qual=0)
    tabs = T.build_tables(params)
    fk, coef, lhet = f32_tables(tabs)
    want = js.call_batch_stacked(
        jnp.asarray(stacked), jnp.asarray(meta), fk, coef, lhet,
        tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
        precision="fast", use_joint=use_joint,
        min_somatic_qual=params.min_somatic_qual, cap_mapq=params.cap_mapq,
        theta=params.theta, eta=params.eta, max_emit=B, glf_backend="xla",
        packed16=packed16, compact=compact)
    s = torch.from_numpy(stacked if packed16 else stacked.view(np.int32))
    got = ts.call_batch_stacked(s, torch.from_numpy(meta),
                                device_tables(build_tables(port_params(params)),
                                              CPU),
                                port_params(params),
                                packed16=packed16, compact=compact,
                                max_emit=B)
    return got, want


def _assert_pm1(a, b):
    d = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert d.max(initial=0) <= 1
    return d


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("packed16", [True, False])
def test_call_batch_stacked_matches_jax(packed16, compact, use_joint):
    B, D = 256, 40
    got, want = _stacked_both(B, D, 20 + 2 * packed16 + use_joint,
                              packed16, use_joint, compact)
    if compact:
        count = int(got.count)
        assert count == int(want.count) > B // 8
        rows = got.rows.numpy()[:count].astype(int)
        rows_w = np.asarray(want.rows)[:count].astype(int)
        assert rows.shape == rows_w.shape == (count, 1 + 16)
        pm1 = [1 + js.COMPACT_FIELDS.index(f) for f in PM1]
        exact = [j for j in range(rows.shape[1]) if j not in pm1]
        np.testing.assert_array_equal(rows[:, exact], rows_w[:, exact])
        d = _assert_pm1(rows, rows_w)
        assert (d == 0).all(axis=1).mean() >= 0.99
        return
    assert got.tumor_dq is None and want.tumor_dq is None
    for f in js.COMPACT_FIELDS + ("emit",):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in PM1:
            d = _assert_pm1(a, b)
            assert (d == 0).mean() >= 0.99
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_call_batch_stacked_caps_rows():
    """K = min(max_emit, B) rows; count still counts every emitted
    column."""
    stacked, meta = random_stacked(128, 16, 7, packed16=True)
    params = ModelParams(min_somatic_qual=0)
    res = ts.call_batch_stacked(torch.from_numpy(stacked),
                                torch.from_numpy(meta),
                                device_tables(build_tables(params), CPU),
                                params, packed16=True, max_emit=4)
    assert res.rows.shape == (4, 17) and int(res.count) > 4
    full = ts.call_batch_stacked(torch.from_numpy(stacked),
                                 torch.from_numpy(meta),
                                 device_tables(build_tables(params), CPU),
                                 params, packed16=True, max_emit=128,
                                 compact=False)
    emitted = np.nonzero(full.emit.numpy())[0]
    np.testing.assert_array_equal(res.rows[:, 0].numpy(), emitted[:4])
    with pytest.raises(TypeError):
        ts.call_batch_stacked(torch.from_numpy(stacked.astype(np.int32)),
                              torch.from_numpy(meta),
                              device_tables(build_tables(params), CPU),
                              params, packed16=True, max_emit=128)


def _sim1_args(data_dir, fmt="vcf"):
    d = data_dir / "e2e" / "sim1"
    return d, ["-F", fmt, "-f", str(d / "ref.fa"), str(d / "tumor.bam"),
               str(d / "normal.bam")]


def _port_lines(d, fmt, ref=True, **kw):
    return list(runner.call_pair(
        str(d / "tumor.bam"), str(d / "normal.bam"),
        str(d / "ref.fa") if ref else None, fmt, precision="fast",
        device=CPU, **kw))


@pytest.fixture
def no_native(monkeypatch):
    """The native host library switched off for the loaders of the port
    and of the JAX package (emit still renders natively, which changes
    no byte)."""
    monkeypatch.setattr(native_api, "available", lambda: False)
    monkeypatch.setattr(jnative_api, "available", lambda: False)


@pytest.mark.parametrize("fmt", ["vcf", "classic"])
def test_cli_without_native_library(data_dir, tmp_path, no_native, fmt):
    d, args = _sim1_args(data_dir, fmt)
    out = tmp_path / f"out.{fmt}"
    STATS.reset()
    assert main(["--device", "cpu", "--precision", "fast", *args,
                 str(out)]) == 0
    assert STATS.snapshot().get("batches_dispatched", 0) > 0
    got = filtered_lines(out)
    diff_records(got, filtered_lines(d / f"expected.{fmt}"), fmt)
    want = list(jrunner.call_pair(
        str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
        precision="fast", fmt=fmt))
    diff_records([ln.rstrip("\n") for ln in got if not ln.startswith("#")],
                 [ln.rstrip("\n") for ln in want], fmt)


def test_collect_pending_refetches_overflow(data_dir, no_native,
                                            monkeypatch):
    """A batch that emits more rows than its compact result holds is
    scored again in full; the lines do not change."""
    d, _ = _sim1_args(data_dir)
    base = _port_lines(d, "vcf")
    assert len(base) > 10
    monkeypatch.setattr(runner, "MAX_EMIT", 3)
    STATS.reset()
    assert _port_lines(d, "vcf") == base
    assert STATS.snapshot().get("batches_refetched", 0) > 0


def test_call_pair_without_reference_emits_nothing(data_dir):
    """No reference: full-u32 batches, every site gated out by
    ref16 = 15, as in the JAX package."""
    d, _ = _sim1_args(data_dir)
    STATS.reset()
    assert _port_lines(d, "vcf", ref=False) == []
    assert STATS.snapshot().get("device_columns", 0) > 0
    assert list(jrunner.call_pair(
        str(d / "tumor.bam"), str(d / "normal.bam"), None,
        precision="fast", fmt="vcf")) == []


def test_exact_and_windowed_still_need_native(data_dir, tmp_path,
                                              no_native, capsys):
    d, args = _sim1_args(data_dir)
    with pytest.raises(runner.NativeUnavailable, match="exact precision"):
        list(runner.call_pair(str(d / "tumor.bam"), str(d / "normal.bam"),
                              str(d / "ref.fa"), "vcf", precision="exact"))
    with pytest.raises(runner.NativeUnavailable, match="windowed driver"):
        list(sharded.call_pair_windows(
            str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
            "vcf", precision="fast", device=CPU))
    # the CLI reports either as an error, exit 1
    for extra in (["--precision", "exact"],
                  ["--precision", "fast", "--shard-index", "0"]):
        assert main(["--device", "cpu", *extra, *args,
                     str(tmp_path / "x")]) == 1
        assert "needs the native host library" in capsys.readouterr().err
    assert set(gk.LAUNCHES.values()) == {0}


FLAG_CASES = {
    "joint": (ModelParams(use_joint_priors=True,
                          somatic_mutation_rate=0.001), "vcf"),
    "loh_gor": (ModelParams(include_loh=False, include_gor=False,
                            min_somatic_qual=0), "vcf"),
    "classic": (ModelParams(), "classic"),
    "bed": (ModelParams(), "bed"),
}


def _lines_windowed(d, window_size, fmt, params):
    out = []
    for _wi, _w, lines in sharded.call_pair_windows(
            str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa"),
            fmt, params=params, precision="fast", window_size=window_size,
            device=CPU):
        out.extend(lines)
    return out


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_mode_mix_ordering(monkeypatch, data_dir, case):
    """Port of tests/test_slab.py test_mode_mix_ordering: a window that
    cannot plan BETWEEN slab windows goes through the batch path with a
    deferred collect, and the open slab dispatcher must be finished
    before it yields; the bytes equal the all-slab run."""
    params, fmt = FLAG_CASES[case]
    d = data_dir / "e2e" / "sim1"
    baseline = _lines_windowed(d, 2_000, fmt, params)

    calls = {"n": 0}
    orig = sharded.can_plan

    def flaky_can_plan(pu_t, pu_n, packed16):
        calls["n"] += 1
        if calls["n"] % 3 == 2:  # every 3rd window takes the batch path
            return False
        return orig(pu_t, pu_n, packed16)

    monkeypatch.setattr(sharded, "can_plan", flaky_can_plan)
    STATS.reset()
    got = _lines_windowed(d, 2_000, fmt, params)
    assert calls["n"] > 3, "fixture must span several windows"
    assert STATS.snapshot().get("batches_dispatched", 0) > 0
    assert got == baseline
