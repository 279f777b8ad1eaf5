"""The captured split over devices and the captured deep fast batch, on
the CPU.

With several devices (``runner.data_mesh``) a slab or a compact batch
whose size the mesh divides is cut into one equal part a device, each
part scored by its own captured step (``parallel.sharding
.graphed_split`` over ``models.step_graph.SlabStepGraph.run_parts``),
and the parts' compact rows merged on the first device
(``models.somatic.merge_compact``): the unsplit step's rows byte for
byte, global column index and overflow included.  A fast batch deeper
than 255 takes its key's captured step too: its assembly's error word
stays on the device and ``runner.collect_pending`` reads it with the
counts.

A CUDA graph exists only on a card; here a registry that captures on
the CPU with the eager step standing in for the replay
(``tests/torch_port_util.eager_stand_in``) runs the routes, with
``forced_mesh([cpu, cpu])`` and ``[cpu, cpu, cpu]``.  The rows are held
to the unsplit step exactly and to the JAX package's unsplit
``call_batch_packed`` / ``call_batch_stacked``: exact precision every
row equal, fast precision the calls equal and the phred fields within
the fast contract (+/-1, 99% of rows equal), as
tests/test_torch_batch_graph.py states it.  The card's graphs are held
to the eager step in tests/test_torch_cuda.py and chip_smoke.py.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (eager_stand_in, f32_tables,  # noqa: E402
                                   port_params, random_slab, random_stacked)

from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as mg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import step_graph as sg  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.parallel import slab  # noqa: E402
from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")
PM1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
       "somatic_score", "joint_cnsq")
LAYOUTS = [(True, "fast"), (False, "fast"), (False, "exact")]
LAYOUT_IDS = ["u16-fast", "u32-fast", "u32-exact"]
JPARAMS = JT.ModelParams(min_somatic_qual=0)
PARAMS = port_params(JPARAMS)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A registry that captures on the CPU in place of the process's."""
    graphs = sg.SlabStepGraph(capture=eager_stand_in, device_types=("cpu",))
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    monkeypatch.setattr(slab, "STEP_GRAPHS", graphs)
    STATS.reset()
    yield graphs
    STATS.reset()


def _batch(b0, D, seed, packed16):
    """A PairedBatch of the batch path's upload layout, its ref16, and
    its upload padded to the bucket as the runner pads it."""
    stacked, meta = random_stacked(b0, D, seed, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    batch = PairedBatch(keys=np.arange(b0, dtype=np.int64), ref16=meta[2],
                        tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                        n_normal=meta[1], **extra)
    B = runner._b_bucket(b0)
    padded = (np.stack([runner._pad_b(x, B) for x in stacked]),
              np.stack([runner._pad_b(x, B) for x in meta]))
    return batch, meta[2], padded


def _unsplit(padded, packed16, dtabs, precision, max_emit):
    """The eager unsplit batch step on the padded upload."""
    stacked, meta = padded
    s = torch.from_numpy(stacked if packed16 else stacked.view(np.int32))
    return ts.call_batch_stacked(s, torch.from_numpy(meta), dtabs, PARAMS,
                                 packed16=packed16, max_emit=max_emit,
                                 precision=precision)


def _bytes(res):
    n = int(res.count)
    return n, res.rows.numpy().tobytes()


def _routes():
    snap = STATS.snapshot()
    return {k: int(v) for k, v in snap.items()
            if k.startswith(("batches_", "batch_captures", "slabs_"))
            and not k.startswith("slabs_at_depth")}


def _held_to_jax(rows, rows_w, exact):
    """The port's emitted rows against the JAX package's on the same
    inputs: exact equal; fast the calls equal, the phred fields +/-1."""
    rows_w = rows_w.astype(int)
    if exact:
        np.testing.assert_array_equal(rows, rows_w)
        return
    pm1 = [1 + js.COMPACT_FIELDS.index(f) for f in PM1]
    same = [j for j in range(rows.shape[1]) if j not in pm1]
    np.testing.assert_array_equal(rows[:, same], rows_w[:, same])
    d = np.abs(rows.astype(int) - rows_w)
    assert d.max() <= 1 and (d == 0).all(axis=1).mean() >= 0.99


def _jax_stacked(padded, packed16, precision):
    tabs = JT.build_tables(JPARAMS)
    fk, coef, lhet = (f32_tables(tabs) if precision == "fast"
                      else (tabs.fk, tabs.coef, tabs.lhet))
    B = padded[0].shape[1]
    return js.call_batch_stacked(
        jnp.asarray(padded[0]), jnp.asarray(padded[1]), fk, coef, lhet,
        tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
        precision=precision, use_joint=False, min_somatic_qual=0,
        cap_mapq=JPARAMS.cap_mapq, theta=JPARAMS.theta, eta=JPARAMS.eta,
        max_emit=min(B, 16384), glf_backend="xla", packed16=packed16)


@pytest.mark.parametrize("n,b0", [(2, 300), (3, 300), (3, 4100)],
                         ids=["2-parts", "3-parts-unsplit", "3-parts"])
@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_split_batch_rows_equal_unsplit_and_jax(cpu_graphs, packed16,
                                                precision, n, b0):
    """Three batches of one key under a mesh of n CPU parts, all left
    pending: the first eager, the second captured (a graph a part), the
    third replayed; each keeps its own rows, byte-equal to the unsplit
    step's on its inputs.  A bucket the mesh does not divide (512 in 3)
    goes unsplit through the ordinary captured route and is counted so.
    The replayed batch is held to the JAX package's unsplit
    ``call_batch_stacked``."""
    D = 8 if b0 > 2048 else 16
    dtabs = device_tables(build_tables(PARAMS), CPU, precision)
    B = runner._b_bucket(b0)
    split = B % n == 0
    pending = []
    with runner.forced_mesh([CPU] * n):
        for seed in (1, 2, 3):
            batch, ref16, padded = _batch(b0, D, 10 * n + seed, packed16)
            pending.append((padded, runner.submit_call_batch(
                batch, ref16, dtabs, CPU, precision=precision)))
    answers = set()
    for padded, res in pending:
        want = _unsplit(padded, packed16, dtabs, precision,
                        min(runner.MAX_EMIT, B))
        assert _bytes(res) == _bytes(want)
        assert int(res.count) > 0 and int(res.err) == 0
        answers.add(_bytes(res))
    assert len(answers) == 3
    key = "split" if split else "unsplit"
    graphed = "batches_graphed_split" if split else "batches_graphed"
    captures = "batch_captures_split" if split else "batch_captures"
    assert _routes() == {f"batches_{key}": 3, "batches_eager_first": 1,
                         graphed: 2, captures: 1}
    assert len(cpu_graphs.captures()) == (n if split else 1)
    assert {k[6] for k in cpu_graphs.captures()} == (
        set(range(n)) if split else {None})

    padded, res = pending[2]
    n_rows = int(res.count)
    want = _jax_stacked(padded, packed16, precision)
    assert int(want.count) == n_rows
    _held_to_jax(res.rows[:n_rows].numpy(), np.asarray(want.rows)[:n_rows],
                 precision == "exact")


@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_split_batch_overflow_and_refetch(cpu_graphs, monkeypatch, packed16,
                                         precision):
    """A batch that emits more than its compact result holds (MAX_EMIT
    cut to 24 here): the merged parts' count and K rows equal the
    unsplit step's, overflow and all, on every route; the full
    CallResult that ``collect_pending`` refetches for it, split by the
    eager ``sharded_call_batch``, equals the unsplit one."""
    monkeypatch.setattr(runner, "MAX_EMIT", 24)
    dtabs = device_tables(build_tables(PARAMS), CPU, precision)
    with runner.forced_mesh([CPU, CPU]):
        for seed in (1, 2, 3):
            batch, ref16, padded = _batch(300, 16, 40 + seed, packed16)
            res = runner.submit_call_batch(batch, ref16, dtabs, CPU,
                                           precision=precision)
            want = _unsplit(padded, packed16, dtabs, precision, 24)
            assert res.rows.shape[0] == 24 < int(res.count)
            assert _bytes(res) == _bytes(want)
        full = runner.submit_call_batch(batch, ref16, dtabs, CPU,
                                        compact=False, precision=precision)
    whole = _unsplit(padded, packed16, dtabs, precision, 24)
    assert int(full.emit.sum()) == int(whole.count)
    plain = runner.submit_call_batch(batch, ref16, dtabs, CPU,
                                     compact=False, precision=precision)
    for name, a, b in zip(plain._fields, full, plain):
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert _routes()["batches_graphed_split"] == 2


def _compact_parts(res, n, max_emit):
    """compact_rows of each of n equal parts of a CallResult."""
    B = res.emit.shape[0]
    pb = B // n
    return [ts.compact_rows(ts.CallResult(*(
        None if v is None else v if name == "err" else v[i * pb:(i + 1) * pb]
        for name, v in res._asdict().items())), min(max_emit, pb))
        for i in range(n)]


@pytest.mark.parametrize("n,B,max_emit,p_emit", [
    (2, 64, 64, 0.3), (4, 64, 64, 0.0), (4, 64, 64, 1.0), (3, 96, 10, 0.5),
    (2, 64, 5, 0.9), (8, 256, 40, 0.2), (2, 64, 64, "col0-only"),
    (3, 96, 96, "not-col0")])
def test_merge_compact_equals_compact_rows(n, B, max_emit, p_emit):
    """The merge of the parts' compactions against the whole batch's
    compaction, every row byte for byte: none emitted, all emitted,
    overflow of the whole and of a part, column 0 emitted alone or
    not at all."""
    rng = np.random.default_rng(B + n + max_emit)
    if p_emit == "col0-only":
        emit = np.zeros(B, bool)
        emit[0] = True
    elif p_emit == "not-col0":
        emit = rng.random(B) < 0.6
        emit[0] = False
    else:
        emit = rng.random(B) < p_emit
    fields = {name: torch.from_numpy(rng.integers(0, 255, B).astype(np.int32))
              for name in ts.CallResult._fields
              if name not in ("emit", "tumor_dq", "normal_dq", "err")}
    dq = torch.from_numpy(rng.integers(0, 99, (B, 18)).astype(np.int32))
    res = ts.CallResult(emit=torch.from_numpy(emit), tumor_dq=dq,
                        normal_dq=dq + 1, **fields)
    want = ts.compact_rows(res, max_emit)
    got = ts.merge_compact(_compact_parts(res, n, max_emit), B // n,
                           max_emit)
    assert int(got.count) == int(want.count) == int(emit.sum())
    assert got.rows.dtype == want.rows.dtype
    assert got.rows.numpy().tobytes() == want.rows.numpy().tobytes()
    assert int(got.err) == 0


def _slab_dispatcher(dtabs):
    return slab.TorchSlabDispatcher(lambda: dtabs, build_tables(PARAMS),
                                    PARAMS, None, CPU)


@pytest.mark.parametrize("n,B", [(2, 96), (3, 96), (3, 100)],
                         ids=["2-parts", "3-parts", "3-parts-unsplit"])
def test_split_slab_rows_equal_unsplit_and_jax(cpu_graphs, n, B):
    """Two slabs through the dispatcher under a mesh of n CPU parts: the
    first captured (a graph a part, after its warm-up steps), the second
    replayed, each counted as split and graphed; rows byte-equal to the
    unsplit eager step's and within the fast contract of the JAX
    package's ``call_batch_packed``.  A slab the mesh does not divide
    goes unsplit through the captured step, counted so."""
    dtabs = device_tables(build_tables(PARAMS), CPU)
    disp = _slab_dispatcher(dtabs)
    tabs = JT.build_tables(JPARAMS)
    fk, coef, lhet = f32_tables(tabs)
    try:
        with runner.forced_mesh([CPU] * n):
            for seed in (1, 2):
                stacked, meta = random_slab(B, 24, 50 + seed)
                n_rows, rows = disp._dispatch_and_fetch(stacked, meta)
                want = ts.call_batch_packed(
                    torch.from_numpy(stacked.view(np.int32)),
                    torch.from_numpy(meta), dtabs, PARAMS)
                assert n_rows == int(want.count) > B // 8
                assert rows.tobytes() == want.rows[:n_rows].numpy().tobytes()
                jw = js.call_batch_packed(
                    jnp.asarray(stacked), jnp.asarray(meta), fk, coef, lhet,
                    tabs.solo_prior, tabs.joint_prior, tabs.qadd,
                    tabs.q_r_int, use_joint=False, min_somatic_qual=0,
                    include_loh=True, include_gor=True, cap_mapq=60,
                    theta=PARAMS.theta, eta=PARAMS.eta, max_emit=B,
                    glf_backend="xla", row_dtype="i32")
                assert int(jw.count) == n_rows
                _held_to_jax(rows, np.asarray(jw.rows)[:n_rows], False)
    finally:
        disp._collector.shutdown()
    split = B % n == 0
    assert _routes() == ({"slabs_split": 2, "slabs_graphed": 2} if split
                         else {"slabs_unsplit": 2, "slabs_graphed": 2})
    assert len(cpu_graphs.captures()) == (n if split else 1)


@pytest.fixture
def poison(monkeypatch):
    """A device tensor added to the rescaled class counts of every deep
    fast column: 0 leaves them as they are, a large value puts them
    outside the assembly tables.  A captured step reads it at its fixed
    address, as a replay on the card would."""
    bad = torch.zeros((1, 4), dtype=torch.int32)
    real = mg.rescale_counts
    monkeypatch.setattr(mg, "rescale_counts", lambda c: real(c) + bad)
    return bad


@pytest.mark.parametrize("route", ["graph", "graph-split", "cpu-eager"])
def test_deep_fast_batch_and_its_error_word(cpu_graphs, monkeypatch, poison,
                                            route):
    """A fast batch of depth 300 (the accumulate, the c_tot > 255
    rescale, the stand-alone assembly) through its key's captured step,
    whole or split over two parts, or on the CPU's eager route: the
    rows equal the JAX package's ``call_batch_stacked`` under the fast
    contract.  A class count pushed outside the tables on purpose
    raises the stand-alone ``assembly10``'s ValueError at
    ``collect_pending`` (at the first eager batch and at a replay),
    never at submit."""
    if route == "cpu-eager":
        monkeypatch.setattr(sg, "STEP_GRAPHS", sg.SlabStepGraph())
    D = 300
    dtabs = device_tables(build_tables(PARAMS), CPU)
    message = re.escape(gk._count_error(256))
    mesh = [CPU, CPU] if route == "graph-split" else None

    def submit(seed):
        batch, ref16, padded = _batch(200, D, seed, False)
        with runner.forced_mesh(mesh):
            res = runner.submit_call_batch(batch, ref16, dtabs, CPU)
        return [(batch, ref16, res)], padded

    def collect(pending):
        return runner.collect_pending(pending, None, None, None, dtabs, CPU)

    poison[0, 1] = 1000
    bad_first, _ = submit(1)
    with pytest.raises(ValueError, match=message):
        collect(bad_first)
    poison.zero_()
    good, padded = submit(2)
    res = good[0][2]
    n_rows = int(res.count)
    assert int(res.err) == 0 and n_rows > 0
    want = _jax_stacked(padded, False, "fast")
    assert int(want.count) == n_rows
    _held_to_jax(res.rows[:n_rows].numpy(), np.asarray(want.rows)[:n_rows],
                 False)
    assert _bytes(res) == _bytes(_unsplit(padded, False, dtabs, "fast",
                                          runner.MAX_EMIT))
    poison[0, 0] = -1000
    bad_replay, _ = submit(3)
    with pytest.raises(ValueError, match=message):
        collect(good + bad_replay)
    if route == "cpu-eager":
        assert _routes() == {"batches_eager_cpu": 3}
        return
    graphed = "batches_graphed_split" if mesh else "batches_graphed"
    assert _routes()[graphed] == 2
    assert len(cpu_graphs.captures()) == (2 if mesh else 1)


@pytest.mark.parametrize("entry", ["glfgen_batch", "call_batch",
                                   "stacked-full", "stacked-compact"])
def test_direct_deep_call_sets_the_error_word(poison, entry):
    """A direct call of a public scoring function on a fast batch of
    depth 300 never raises on an out-of-table count: it sets the error
    word, which is 0 on the same inputs in the tables, and the column
    pushed out gets zero likelihoods."""
    dtabs = device_tables(build_tables(PARAMS), CPU)
    _, _, (stacked, meta) = _batch(40, 300, 8, False)
    s, m = torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta)

    def score():
        if entry.startswith("stacked"):
            return ts.call_batch_stacked(
                s, m, dtabs, PARAMS, packed16=False, max_emit=64,
                compact=entry == "stacked-compact")
        cb_t, cb_n = ts.stacked_column_batches(s, m, False)
        if entry == "call_batch":
            return ts.call_batch(cb_t, cb_n, dtabs, PARAMS)
        return mg.glfgen_batch(cb_t, dtabs, PARAMS.cap_mapq)

    good = score()
    assert int(good.err.max()) == 0
    poison[0, 3] = 1000
    bad = score()
    assert int(bad.err.max()) == 1
    if entry == "glfgen_batch":
        assert not bad.lk.any() and not bad.min_lk.any()
        assert good.lk.any()


def test_run_call_batch_raises_on_the_error_word(poison):
    """The synchronous full-result wrapper reads the error word in its
    one copy and raises as collect_pending does."""
    dtabs = device_tables(build_tables(PARAMS), CPU)
    batch, ref16, _ = _batch(40, 300, 7, False)
    good = runner.run_call_batch(batch, ref16, dtabs, CPU)
    assert good.err is None and int(good.emit.sum()) > 0
    poison[0, 2] = 999
    with pytest.raises(ValueError, match="table depth"):
        runner.run_call_batch(batch, ref16, dtabs, CPU)


@pytest.mark.parametrize("failing_part", [0, 1])
def test_failed_part_capture_raises_and_keeps_no_graph(monkeypatch,
                                                      failing_part):
    """A split key's second batch captures a graph a part; a part whose
    capture fails raises out of submit_call_batch, no part keeps a
    graph, and no eager step scores the batch in its place."""
    calls = []

    def flaky(step, stream, pool):
        calls.append(1)
        if len(calls) == failing_part + 1:
            step()
            raise RuntimeError("capture failed")
        return eager_stand_in(step, stream, pool)

    graphs = sg.SlabStepGraph(capture=flaky, device_types=("cpu",))
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    STATS.reset()
    dtabs = device_tables(build_tables(PARAMS), CPU)
    batch, ref16, _ = _batch(100, 16, 3, True)
    with runner.forced_mesh([CPU, CPU]):
        runner.submit_call_batch(batch, ref16, dtabs, CPU)
        with pytest.raises(RuntimeError, match="capture failed"):
            runner.submit_call_batch(batch, ref16, dtabs, CPU)
    assert graphs.captures() == {}
    assert len(calls) == failing_part + 1
    assert _routes() == {"batches_split": 2, "batches_eager_first": 1}
    STATS.reset()


@pytest.mark.parametrize("shift", [5, -1])
def test_assembly10_flagged_on_cpu(shift):
    """The assembly with its error word left as a tensor, on the CPU:
    equal to the plain version where every count lies inside the
    tables; columns pushed outside them get zeros and set the word,
    where ``assembly10`` itself raises."""
    B, D = 301, 16
    dtabs = device_tables(build_tables(PARAMS), CPU)
    stacked, meta = random_slab(B, D, 11)
    cb, _ = ts.packed_column_batches(
        torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta))
    e, f, c, _ = gk.accumulate32(cb.slots, cb.n_keep, cb.ref16,
                                 dtabs.fk_weights, 60)
    tabs = dtabs.assembly_tables(D)
    lk_p, mlk_p = gk.assembly10_plain(e, f, c, cb.n_keep, *tabs)
    lk, mlk, err = gk.assembly10_flagged(e, f, c, cb.n_keep, *tabs)
    assert err.tolist() == [0]
    assert torch.equal(lk, lk_p) and torch.equal(mlk, mlk_p)
    bad = torch.zeros(B, dtype=torch.bool)
    bad[[0, 5, 150, 300]] = True
    c_bad = torch.where(bad[:, None], c + shift * (D + 1), c)
    lk, mlk, err = gk.assembly10_flagged(e, f, c_bad, cb.n_keep, *tabs)
    assert err.dtype == torch.int32 and err.tolist() == [1]
    assert torch.equal(lk[~bad], lk_p[~bad])
    assert torch.equal(mlk[~bad], mlk_p[~bad])
    assert int(lk[bad].abs().max()) == 0 and int(mlk[bad].abs().max()) == 0
    with pytest.raises(ValueError, match="table depth"):
        gk.assembly10(e, f, c_bad, cb.n_keep, *tabs)
