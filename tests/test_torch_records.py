"""The port's record API against the JAX package's: ``fmt=None``,
``prefilter``, ``max_batch``, ``run_call_batch`` and the two environment
variables ``SNIPER_PLAN_GATE`` and ``SNIPER_LOOKAHEAD``.

Every route of ``call_pair`` and ``call_pair_windows`` yields
``SniperRecord`` objects when ``fmt`` is None: in exact precision they
equal the JAX package's field for field, dqstats included; in fast
precision their formatted lines lie inside the fast contract of the JAX
package's (``utils.contract.diff_records``), with the histogram of
tolerated differences asserted (none on these fixtures).  Formatting the
records gives the bytes of the ``fmt=`` run.  The port runs on the CPU
by name; the JAX package as its own tests run it there.
"""

import dataclasses
import io
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_port_util import port_params, random_stacked  # noqa: E402

from somatic_sniper_tpu import runner as jrunner  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.parallel import sharded as jsharded  # noqa: E402
from somatic_sniper_tpu.pileup.columnize import (  # noqa: E402
    PairedBatch as JPairedBatch)
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.io import native_api  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.output.formatters import get_formatter  # noqa: E402
from somatic_sniper_tpu_torch.output.records import SniperRecord  # noqa: E402
from somatic_sniper_tpu_torch.parallel import sharded  # noqa: E402
from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch  # noqa: E402
from somatic_sniper_tpu_torch.utils.contract import diff_records, hist  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")


def _pair(data_dir, which):
    if which == "golden":
        return (str(data_dir / "t-small.bam"), str(data_dir / "n-small.bam"),
                str(data_dir / "small.fa"))
    d = data_dir / "e2e" / "sim1"
    return str(d / "tumor.bam"), str(d / "normal.bam"), str(d / "ref.fa")


def _plain(rec) -> dict:
    """A record of either package as plain python values."""
    def sample(s):
        d = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
             if f.name != "dqstats"}
        dq = s.dqstats
        d["dqstats"] = {
            f.name: (int(v) if np.ndim(v := getattr(dq, f.name)) == 0
                     else [int(x) for x in v])
            for f in dataclasses.fields(dq)}
        return d

    assert type(rec).__name__ == "SniperRecord"
    return dict(seq_name=rec.seq_name, pos=int(rec.pos),
                ref_base=int(rec.ref_base), ref_base4=int(rec.ref_base4),
                tumor=sample(rec.tumor), normal=sample(rec.normal))


def _format(records, fmt="vcf") -> list[str]:
    """The lines the port's reference formatters print for records."""
    _, record_fn = get_formatter(fmt)
    fh = io.StringIO()
    for rec in records:
        record_fn(fh, rec)
    return fh.getvalue().splitlines(keepends=True)


def _port_records(args, driver, precision, fmt=None, **kw):
    if driver == "whole":
        return list(runner.call_pair(*args, fmt, precision=precision,
                                     device=CPU, **kw))
    kw.setdefault("window_size", 700)
    return list(sharded.call_pair_sharded(*args, fmt, precision=precision,
                                          device=CPU, **kw))


def _jax_records(args, driver, precision, **kw):
    if driver == "whole":
        return list(jrunner.call_pair(*args, precision=precision, **kw))
    kw.setdefault("window_size", 700)
    return list(jsharded.call_pair_sharded(*args, precision=precision, **kw))


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("driver", ["whole", "windowed"])
@pytest.mark.parametrize("which", ["golden", "sim1"])
def test_records_match_the_jax_package(data_dir, monkeypatch, tmp_path, which,
                                       driver, precision):
    """(a) ``fmt=None`` on every driver and precision.  The fast runs
    dispatch however few columns the plan leaves, so that the slab route
    builds the records, in both packages (tests/conftest.py holds the
    JAX package's host threshold at 0)."""
    args = _pair(data_dir, which)
    if which == "golden" and driver == "windowed":
        # the windowed driver writes a BAM's index beside it
        args = tuple(shutil.copy(a, tmp_path) for a in args)
    got = _port_records(args, driver, precision)
    want = _jax_records(args, driver, precision)
    assert got and all(isinstance(r, SniperRecord) for r in got)
    if precision == "exact":
        assert [_plain(r) for r in got] == [_plain(r) for r in want]
    else:
        tolerated = diff_records(_format(got), _format(want), "vcf")
        assert hist(tolerated) == {}
    # formatting the records gives the bytes of the fmt= run
    for fmt in ("vcf", "classic", "bed"):
        assert _format(got, fmt) == _port_records(args, driver, precision,
                                                  fmt)


def test_batch_route_builds_records(data_dir, monkeypatch):
    """(a) the batch route (no native library: pure-Python pileups, u16
    batches) walks the pileups for its dqstats and builds the same
    records as the slab route, which takes them from its rows."""
    args = _pair(data_dir, "sim1")
    slab = _port_records(args, "whole", "fast")
    monkeypatch.setattr(native_api, "available", lambda: False)
    STATS.reset()
    batch = _port_records(args, "whole", "fast")
    assert STATS.snapshot().get("batches_dispatched", 0) > 0
    assert [_plain(r) for r in batch] == [_plain(r) for r in slab]
    assert _format(batch) == _port_records(args, "whole", "fast", "vcf")


PARAMS = {
    "q0": dict(min_somatic_qual=0),
    "joint": dict(use_joint_priors=True, include_loh=False,
                  include_gor=False, min_somatic_qual=0),
    "default": {},
}


@pytest.mark.parametrize("params", list(PARAMS))
@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("driver", ["whole", "windowed"])
def test_prefilter_output_identical(data_dir, monkeypatch, driver, precision,
                                    params):
    """(b) tests/test_prefilter.py:88-105 and :150-164 on the port: the
    prefilter and the plan's gate drop only columns that could never
    emit, so on and off give the same records, and the same as the JAX
    package's unfiltered run."""
    args = _pair(data_dir, "sim1")
    p = ModelParams(**PARAMS[params])
    STATS.reset()
    on = _port_records(args, driver, precision, params=p, prefilter=True)
    scored_on = STATS.snapshot().get("columns_scored", 0)
    STATS.reset()
    off = _port_records(args, driver, precision, params=p, prefilter=False)
    scored_off = STATS.snapshot().get("columns_scored", 0)
    assert len(on) > 0
    assert [_plain(r) for r in on] == [_plain(r) for r in off]
    # off scores every shared column, on next to none
    assert scored_off > 20 * max(scored_on, 1)
    if precision == "exact" and params == "q0":
        want = _jax_records(args, driver, precision,
                            params=T.ModelParams(**PARAMS[params]),
                            prefilter=False)
        assert [_plain(r) for r in off] == [_plain(r) for r in want]


def test_prefilter_off_on_the_batch_route(data_dir, monkeypatch):
    """(b) without the native library the batch route takes its
    pure-reference flags only when ``prefilter`` is on."""
    args = _pair(data_dir, "sim1")
    monkeypatch.setattr(native_api, "available", lambda: False)
    cols = {}
    for pf in (True, False):
        STATS.reset()
        cols[pf] = (_port_records(args, "whole", "fast", "vcf", prefilter=pf),
                    STATS.snapshot().get("device_columns", 0))
    assert cols[True][0] == cols[False][0] and len(cols[True][0]) > 10
    assert cols[False][1] > cols[True][1] > 0


@pytest.mark.parametrize("driver", ["whole", "windowed"])
def test_plan_gate_env_reaches_the_plan(data_dir, monkeypatch, driver):
    """(b) F2, tests/test_prefilter.py:167-189: SNIPER_PLAN_GATE decides
    the ``cns_mode`` that reaches ``paired_plan``; without it the
    callers' "proof" does; the records never change."""
    args = _pair(data_dir, "sim1")
    seen = []
    real = native_api.paired_plan

    def spy(*a, **kw):
        seen.append(kw["cns_mode"])
        return real(*a, **kw)

    monkeypatch.setattr(native_api, "paired_plan", spy)
    out = {}
    for gate in ("full", "proof", None):
        if gate is None:
            monkeypatch.delenv("SNIPER_PLAN_GATE")
        else:
            monkeypatch.setenv("SNIPER_PLAN_GATE", gate)
        seen.clear()
        STATS.reset()
        recs = _port_records(args, driver, "fast")
        assert seen and set(seen) == {gate or "proof"}
        out[gate] = ([_plain(r) for r in recs],
                     STATS.snapshot().get("columns_scored", 0))
    assert out["full"][0] == out["proof"][0] == out[None][0]
    n = len(out["full"][0])
    assert n > 0
    # the gates' strength, as the JAX package's test pins it
    assert out["full"][1] <= max(2 * n, 64)
    assert out["full"][1] <= out["proof"][1] <= max(4 * n, 64)


def test_lookahead_env_reaches_the_driver(data_dir, monkeypatch):
    """(b) F2: SNIPER_LOOKAHEAD sets the windows in flight, at least
    one, a bad value is ignored; the lines never change."""
    args = _pair(data_dir, "sim1")
    monkeypatch.setenv("SNIPER_LOAD_POOL", "5")  # computed lookahead: 4
    out = {}
    for value in ("1", "5", "0", "garbage", None):
        if value is None:
            monkeypatch.delenv("SNIPER_LOOKAHEAD")
        else:
            monkeypatch.setenv("SNIPER_LOOKAHEAD", value)
        STATS.reset()
        lines = _port_records(args, "windowed", "fast", "vcf")
        out[value] = (lines, STATS.snapshot()["lookahead_windows"])
    assert [out[v][1] for v in ("1", "5", "0", "garbage", None)] \
        == [1, 5, 1, 4, 4]
    assert all(o[0] == out[None][0] for o in out.values())
    assert len(out[None][0]) > 10
    want = list(jsharded.call_pair_sharded(*args, precision="fast",
                                           window_size=700, fmt="vcf"))
    assert hist(diff_records(out[None][0], want, "vcf")) == {}


@pytest.mark.parametrize("driver", ["whole", "windowed"])
def test_max_batch_splits_the_batch_route(data_dir, monkeypatch, driver):
    """(b) ``max_batch`` reaches ``submit_batches``: 7 columns a batch
    makes more batches and the same lines.  Whole-file without the
    native library; windowed without a reference (full-u32 batches,
    exact, nothing emitted: ref16 is 15)."""
    t, n, ref = _pair(data_dir, "sim1")
    if driver == "whole":
        monkeypatch.setattr(native_api, "available", lambda: False)
        args, precision, kw = (t, n, ref), "fast", {}
    else:
        args, precision, kw = (t, n, None), "exact", {"window_size": 2000}
    out = {}
    for mb in (None, 7):
        STATS.reset()
        if mb is not None:
            kw["max_batch"] = mb
        lines = _port_records(args, driver, precision, "vcf", **kw)
        out[mb] = (lines, STATS.snapshot().get("batches_dispatched", 0))
    assert out[7][0] == out[None][0]
    assert out[7][1] > 4 * out[None][1] > 0
    if driver == "whole":
        assert len(out[7][0]) > 10


@pytest.mark.parametrize("packed16,precision", [
    (True, "fast"), (False, "fast"), (False, "exact"),
], ids=["u16-fast", "u32-fast", "u32-exact"])
def test_run_call_batch_matches_jax(packed16, precision):
    """(c) the synchronous wrapper on one seeded batch per encoding:
    every field an integer array on the host, equal to the JAX
    package's.  The reference is ``submit_call_batch`` and a fetch, what
    the JAX ``run_call_batch`` wraps: that wrapper itself slices the
    ``None`` dqstats fields of a batch's CallResult and raises."""
    B, D = 96, 24
    stacked, meta = random_stacked(B, D, 11, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    fields = dict(keys=np.arange(B, dtype=np.int64), ref16=meta[2],
                  tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                  n_normal=meta[1], **extra)
    jparams = T.ModelParams(min_somatic_qual=0)
    params = port_params(jparams)
    got = runner.run_call_batch(
        PairedBatch(**fields), meta[2],
        device_tables(build_tables(params), CPU, precision), CPU, precision)
    with jrunner._exact_cpu_ctx(precision):
        want, b0 = jrunner.submit_call_batch(
            JPairedBatch(**fields), meta[2], None,
            jrunner.get_device_tables(jparams, precision), precision)
    assert b0 == B and int(got.emit.sum()) > B // 8
    assert got.emit.dtype == bool
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert isinstance(a, np.ndarray) and a.shape == (B,), name
        np.testing.assert_array_equal(a.astype(np.int64),
                                      np.asarray(b)[:B].astype(np.int64),
                                      name)


def test_emit_records_takes_a_host_call_result(data_dir):
    """``emit_records`` builds lines and records from the arrays of
    ``run_call_batch`` as from the device's tensors."""
    args = _pair(data_dir, "sim1")
    params = ModelParams(min_somatic_qual=0)
    tabs = build_tables(params)
    _, pu_t, _, pu_n = runner._load_pileups(args[0], args[1], params)
    from somatic_sniper_tpu_torch.io.bam import read_bam_header
    from somatic_sniper_tpu_torch.io.fasta import FastaFile
    from somatic_sniper_tpu_torch.pileup.columnize import paired_batches

    refcache = runner.RefCache(FastaFile(args[2]), read_bam_header(args[0]))
    dtabs = device_tables(tabs, CPU, "exact")
    lines, recs = [], []
    for batch in paired_batches(pu_t, pu_n, max_batch=runner.MAX_BATCH):
        _, ref16 = runner._ref_arrays(batch, refcache)
        res = runner.run_call_batch(batch, ref16, dtabs, CPU, "exact")
        lines += runner.emit_records(batch.keys, res, ref16, pu_t, pu_n,
                                     refcache, "vcf")
        recs += runner.emit_records(batch.keys, res, ref16, pu_t, pu_n,
                                    refcache)
    lines.sort(key=lambda kv: kv[0])
    recs.sort(key=lambda kv: kv[0])
    want = _port_records(args, "whole", "exact", "vcf", params=params)
    assert [ln for _, ln in lines] == want and len(want) > 10
    assert _format([r for _, r in recs]) == want
