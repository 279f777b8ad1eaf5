"""The batch path's captured scoring step (runner.submit_call_batch over
models/step_graph) on the CPU.

The batch axis is padded to the JAX package's buckets (``_b_bucket``):
the padded columns are empty and never emit, so a padded batch gives the
unpadded call's count and rows, and both give the JAX package's
``call_batch_stacked`` (fast: calls equal, f32-sum fields within the
fast contract; exact: every row equal).  The exact f64 sum runs to the
batch's static depth on a card and gives the bits of the sum to the
deepest column.

A CUDA graph exists only on a card; here a registry that captures on
the CPU with the eager step standing in for the replay
(``tests/torch_port_util.eager_stand_in``) holds what surrounds the
graph: the capture policy (a key's first batch eager, its second
captured, later ones replayed, a one-off tail never captured), the
route of a deep fast batch, the CPU's eager route, their counters, the
launch counts, pending replays of one key each keeping its own rows at
sizes across the bucket edges (held to the JAX package), a batch that
emits more rows than its compact result holds and its full refetch,
and a failed capture.  The card's graph is held to the eager step in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (eager_stand_in, f32_tables,  # noqa: E402
                                   held_to_jax, jax_call_batch_stacked,
                                   paired_batch, port_params, random_stacked,
                                   random_u32)

from somatic_sniper_tpu import runner as jrunner  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as mg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import step_graph as sg  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")
PM1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
       "somatic_score", "joint_cnsq")
ROUTES = ("batches_graphed", "batch_captures", "batches_eager_first",
          "batches_eager_cpu")
LAYOUTS = [(True, "fast"), (False, "fast"), (False, "exact")]
LAYOUT_IDS = ["u16-fast", "u32-fast", "u32-exact"]


def _bucket_edges():
    edges, B = [], 256
    while B < 70000:
        edges += [B - 1, B, B + 1]
        B = B * 2 if B < 2048 else B + 2048
    return edges


def test_b_bucket_and_pad_b_match_jax():
    """Every bucket edge to 70000 and a sample between them; the padding
    appends zero rows and leaves a full batch as it is."""
    rng = np.random.default_rng(0)
    bs = sorted({1, 2, 70000, *_bucket_edges(),
                 *rng.integers(1, 70001, 2000).tolist()})
    assert [runner._b_bucket(b) for b in bs] == \
        [jrunner._b_bucket(b) for b in bs]
    assert {runner._b_bucket(b) for b in range(1, 4097)} == \
        {256, 512, 1024, 2048, 4096}
    assert runner._b_bucket(65536) == 65536
    a = rng.integers(0, 9, (5, 3)).astype(np.int32)
    for B in (5, 8):
        got, want = runner._pad_b(a, B), jrunner._pad_b(a, B)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert runner._pad_b(a, 5) is a


def _batch(B, D, seed, packed16):
    """A PairedBatch of the batch path's upload layout and its ref16."""
    stacked, meta = random_stacked(B, D, seed, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    return PairedBatch(keys=np.arange(B, dtype=np.int64), ref16=meta[2],
                       tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                       n_normal=meta[1], **extra), meta[2]


def _port_stacked(stacked, meta, packed16, dtabs, params, precision,
                  max_emit):
    s = torch.from_numpy(stacked if packed16 else stacked.view(np.int32))
    return ts.call_batch_stacked(s, torch.from_numpy(meta), dtabs, params,
                                 packed16=packed16, max_emit=max_emit,
                                 precision=precision)


def _rows(res):
    n = int(res.count)
    return n, res.rows[:n].numpy()


@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_padded_batch_equals_unpadded_and_jax(packed16, precision):
    """300 columns padded to the 512 bucket as the runner pads them: the
    count and the rows equal the unpadded call's and the runner's, and
    the JAX package's ``call_batch_stacked`` on the same padded upload
    (fast: within the fast contract; exact: equal)."""
    b0, D = 300, 24
    B = runner._b_bucket(b0)
    assert B == 512
    stacked, meta = random_stacked(b0, D, 60 + packed16, packed16)
    stacked_p = np.stack([runner._pad_b(x, B) for x in stacked])
    meta_p = np.stack([runner._pad_b(x, B) for x in meta])
    jparams = JT.ModelParams(min_somatic_qual=0)
    params = port_params(jparams)
    dtabs = device_tables(build_tables(params), CPU, precision)
    n0, rows0 = _rows(_port_stacked(stacked, meta, packed16, dtabs, params,
                                    precision, runner.MAX_EMIT))
    padded = _port_stacked(stacked_p, meta_p, packed16, dtabs, params,
                           precision, runner.MAX_EMIT)
    assert padded.rows.shape[0] == min(runner.MAX_EMIT, B)
    n, rows = _rows(padded)
    assert n == n0 > b0 // 8
    np.testing.assert_array_equal(rows, rows0)
    assert rows[:, 0].max() < b0  # no padded column emits
    batch, ref16 = _batch(b0, D, 60 + packed16, packed16)
    assert _rows(runner.submit_call_batch(batch, ref16, dtabs, CPU,
                                          precision=precision))[1].tobytes() \
        == rows0.tobytes()

    tabs = JT.build_tables(jparams)
    fk, coef, lhet = (f32_tables(tabs) if precision == "fast"
                      else (tabs.fk, tabs.coef, tabs.lhet))
    want = js.call_batch_stacked(
        jnp.asarray(stacked_p), jnp.asarray(meta_p), fk, coef, lhet,
        tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
        precision=precision, use_joint=False, min_somatic_qual=0,
        cap_mapq=jparams.cap_mapq, theta=jparams.theta, eta=jparams.eta,
        max_emit=min(B, 16384), glf_backend="xla", packed16=packed16)
    assert int(want.count) == n
    rows_w = np.asarray(want.rows)[:n].astype(int)
    if precision == "exact":
        np.testing.assert_array_equal(rows, rows_w)
        return
    pm1 = [1 + js.COMPACT_FIELDS.index(f) for f in PM1]
    exact = [j for j in range(rows.shape[1]) if j not in pm1]
    np.testing.assert_array_equal(rows[:, exact], rows_w[:, exact])
    d = np.abs(rows.astype(int) - rows_w)
    assert d.max() <= 1 and (d == 0).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("D,depth_cap", [(1, None), (16, None), (40, None),
                                         (64, 9), (300, None)])
def test_exact_sum_to_static_depth_is_bit_equal(D, depth_cap):
    """The serial f64 sum over all D sorted positions (what a captured
    step runs) against the sum to the deepest column (the CPU's trip
    count): the same bits in every sum, including a batch whose deepest
    column is far below D."""
    B = 96
    slots, depth, ref16 = random_u32(B, D, seed=70 + D)
    if depth_cap is not None:
        depth = np.minimum(depth, depth_cap).astype(np.int32)
        slots = np.where(np.arange(D)[None, :] < depth[:, None], slots, 0)
    cols = mg.ColumnBatch(
        slots=torch.from_numpy(slots.astype(np.uint32).view(np.int32)),
        depth=torch.from_numpy(depth), ref16=torch.from_numpy(ref16))
    info, n = mg.pack_info(cols)
    info = torch.sort(info, dim=1).values
    fk = device_tables(build_tables(ModelParams()), CPU, "exact").fk
    to_top = mg._exact_accumulate(info, n, fk, 60)
    to_d = mg._exact_accumulate(info, n, fk, 60, steps=D)
    if depth_cap is not None:
        assert int(n.max()) <= depth_cap < D // 4
    assert float(to_top[0].abs().sum()) > 0
    for a, b in zip(to_top, to_d):
        assert a.dtype == b.dtype
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


def test_batch_keys_tell_layouts_and_precisions_apart():
    params = ModelParams()
    dtabs = device_tables(build_tables(params), CPU)
    key = sg.SlabStepGraph.key
    specs = [sg.SLAB, sg.StepSpec(True, "fast", 4096),
             sg.StepSpec(False, "fast", 4096),
             sg.StepSpec(False, "exact", 4096),
             sg.StepSpec(False, "fast", 2048)]
    assert len({key(CPU, 4096, 40, params, dtabs, s) for s in specs}) == 5
    assert key(CPU, 4096, 40, params, dtabs) == \
        key(CPU, 4096, 40, params, dtabs, sg.SLAB)
    assert [(s.stacked_dtype, s.meta_rows) for s in specs[1:3]] == \
        [(torch.uint16, 7), (torch.int32, 3)]


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A registry that captures on the CPU, the eager step standing in
    for the replay, in place of the process's; the batch kernels count a
    launch as the card's wrappers do."""
    graphs = sg.SlabStepGraph(capture=eager_stand_in, device_types=("cpu",))
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    for name, key in (("glfgen_u32", "glfgen"), ("glfgen16", "glfgen16")):
        def counted(*args, _f=getattr(gk, name), _k=key):
            gk.LAUNCHES[_k] += 1
            return _f(*args)

        monkeypatch.setattr(mg, name, counted)
    gk.reset_launches()
    STATS.reset()
    yield graphs
    gk.reset_launches()
    STATS.reset()


def _routes():
    snap = STATS.snapshot()
    return {k: int(snap.get(k, 0)) for k in ROUTES if snap.get(k)}


@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_capture_policy_and_pending_rows(cpu_graphs, packed16, precision):
    """Four batches of one key, then a tail of another, all left pending:
    the first batch eager, the second captured, the third and fourth
    replayed, the tail eager and never captured.  Each pending result
    keeps its own rows (the replays write the same fixed buffers), each
    equal to the eager step on its own inputs; a fast batch counts its
    two launches on every route, the warm-up and the capture none; the
    upload, the step and the capture each count in a stage of their
    own."""
    D = 16
    params = ModelParams(min_somatic_qual=0)
    dtabs = device_tables(build_tables(params), CPU, precision)
    sizes = [(200, 1), (256, 2), (130, 3), (255, 4), (700, 5)]
    pending = []
    for b0, seed in sizes:
        batch, ref16 = _batch(b0, D, seed, packed16)
        pending.append((batch, ref16, runner.submit_call_batch(
            batch, ref16, dtabs, CPU, precision=precision)))
    assert _routes() == {"batches_eager_first": 2, "batch_captures": 1,
                         "batches_graphed": 3}
    assert [STATS.calls[k] for k in ("device.upload", "device.score",
                                     "device.capture")] == [5, 5, 1]
    enc = "u16" if packed16 else "u32"
    snap = STATS.snapshot()
    assert snap[f"batch_key_{enc}_{precision}_256x{D}"] == 4
    assert snap[f"batch_key_{enc}_{precision}_1024x{D}"] == 1
    spec = sg.StepSpec(packed16, precision, 256)
    assert list(cpu_graphs.captures()) == [
        cpu_graphs.key(CPU, 256, D, params, dtabs, spec)]
    fused = "glfgen16" if packed16 else "glfgen"
    want_launches = 2 * len(sizes) if precision == "fast" else 0
    assert sum(gk.LAUNCHES.values()) == gk.LAUNCHES[fused] == want_launches
    answers = []
    for (batch, ref16, res), (b0, seed) in zip(pending, sizes):
        stacked, meta = random_stacked(b0, D, seed, packed16)
        want = _port_stacked(stacked, meta, packed16, dtabs, params,
                             precision, runner.MAX_EMIT)
        n, rows = _rows(res)
        assert (n, rows.tobytes()) == (int(want.count),
                                       _rows(want)[1].tobytes())
        assert n > 0
        answers.append(rows.tobytes())
    assert len(set(answers)) == len(answers)


@pytest.mark.parametrize("route", ["deep", "cpu"])
def test_eager_routes_are_counted_and_never_captured(cpu_graphs, monkeypatch,
                                                    route):
    """Three batches of one key.  A fast batch deeper than 255 (its
    assembly's error word stays on the device) takes the captured route:
    the first eager, the second captured, the third replayed, each
    counted as such.  Only the CPU without a capturing registry scores
    eagerly three times and captures nothing.  An exact batch deeper
    than 255 takes the captured route too."""
    D = 300 if route == "deep" else 16
    params = ModelParams(min_somatic_qual=0)
    dtabs = device_tables(build_tables(params), CPU)
    if route == "cpu":
        monkeypatch.setattr(sg, "STEP_GRAPHS", sg.SlabStepGraph())
    for seed in (1, 2, 3):
        batch, ref16 = _batch(64, D, seed, False)
        res = runner.submit_call_batch(batch, ref16, dtabs, CPU)
        stacked, meta = random_stacked(64, D, seed, False)
        want = _port_stacked(stacked, meta, False, dtabs, params,
                             "fast", runner.MAX_EMIT)
        assert _rows(res)[1].tobytes() == _rows(want)[1].tobytes()
        assert int(res.err) == 0
    spec = sg.StepSpec(False, "fast", 256)
    if route == "cpu":
        assert _routes() == {"batches_eager_cpu": 3}
        assert cpu_graphs.captures() == {}
    else:
        assert _routes() == {"batches_eager_first": 1, "batch_captures": 1,
                             "batches_graphed": 2}
        assert list(cpu_graphs.captures()) == [
            cpu_graphs.key(CPU, 256, D, params, dtabs, spec)]
        exact = device_tables(build_tables(params), CPU, "exact")
        for seed in (1, 2):
            batch, ref16 = _batch(64, D, seed, False)
            runner.submit_call_batch(batch, ref16, exact, CPU,
                                     precision="exact")
        assert _routes()["batch_captures"] == 2


LAYOUTS_B0 = [1, 255, 256, 300, 2048, 2049, 4100]


@pytest.mark.parametrize("b0", LAYOUTS_B0)
@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_whole_batch_rows_equal_jax(cpu_graphs, packed16, precision, b0):
    """Three batches of one key at sizes across the bucket edges, all
    left pending: the first eager, the second captured, the third
    replayed; each keeps its own rows, byte-equal to the eager step's on
    its padded upload, and the replayed one is held to the JAX
    package's ``call_batch_stacked`` (exact: equal; fast: the fast
    contract)."""
    D = 8 if b0 > 2048 else 16
    jparams = JT.ModelParams(min_somatic_qual=0)
    params = port_params(jparams)
    dtabs = device_tables(build_tables(params), CPU, precision)
    B = runner._b_bucket(b0)
    K = min(runner.MAX_EMIT, B)
    pending = []
    for seed in (1, 2, 3):
        batch, ref16, padded = paired_batch(b0, D, 10 * seed + b0, packed16)
        pending.append((padded, runner.submit_call_batch(
            batch, ref16, dtabs, CPU, precision=precision)))
    answers = set()
    for padded, res in pending:
        want = _port_stacked(*padded, packed16, dtabs, params, precision, K)
        assert res.rows.shape[0] == K and int(res.err) == 0
        assert (int(res.count), res.rows.numpy().tobytes()) == \
            (int(want.count), want.rows.numpy().tobytes())
        assert int(res.count) > 0 or b0 == 1
        answers.add(res.rows.numpy().tobytes())
    assert len(answers) == 3
    assert _routes() == {"batches_eager_first": 1, "batch_captures": 1,
                         "batches_graphed": 2}
    assert list(cpu_graphs.captures()) == [cpu_graphs.key(
        CPU, B, D, params, dtabs, sg.StepSpec(packed16, precision, K))]
    padded, res = pending[2]
    n = int(res.count)
    want = jax_call_batch_stacked(padded, packed16, precision, jparams)
    assert int(want.count) == n
    held_to_jax(res.rows[:n].numpy(), np.asarray(want.rows)[:n],
                precision == "exact")


@pytest.mark.parametrize("packed16,precision", LAYOUTS, ids=LAYOUT_IDS)
def test_whole_batch_overflow_and_refetch(cpu_graphs, monkeypatch, packed16,
                                          precision):
    """A batch that emits more than its compact result holds (MAX_EMIT
    cut to 24 here): on every route the count and the 24 rows equal the
    eager step's, overflow and all; the full CallResult that
    ``collect_pending`` refetches for it (the eager step, never
    captured) equals ``call_batch`` on the unpadded batch, and its first
    24 emitted columns are the compact rows."""
    monkeypatch.setattr(runner, "MAX_EMIT", 24)
    params = ModelParams(min_somatic_qual=0)
    dtabs = device_tables(build_tables(params), CPU, precision)
    for seed in (1, 2, 3):
        batch, ref16, padded = paired_batch(300, 16, 40 + seed, packed16)
        res = runner.submit_call_batch(batch, ref16, dtabs, CPU,
                                       precision=precision)
        want = _port_stacked(*padded, packed16, dtabs, params, precision, 24)
        assert res.rows.shape[0] == 24 < int(res.count)
        assert (int(res.count), res.rows.numpy().tobytes()) == \
            (int(want.count), want.rows.numpy().tobytes())
    assert _routes() == {"batches_eager_first": 1, "batch_captures": 1,
                         "batches_graphed": 2}
    full = runner.submit_call_batch(batch, ref16, dtabs, CPU, compact=False,
                                    precision=precision)
    assert len(cpu_graphs.captures()) == 1
    stacked, meta = random_stacked(300, 16, 43, packed16)
    s = torch.from_numpy(stacked if packed16 else stacked.view(np.int32))
    whole = ts.call_batch(*ts.stacked_column_batches(
        s, torch.from_numpy(meta), packed16), dtabs, params, precision)
    for name, a, b in zip(whole._fields, full, whole):
        assert (a is None) == (b is None), name
        if a is not None and name != "err":
            assert a.shape[0] == 300 and torch.equal(a, b), name
    assert int(full.emit.sum()) == int(res.count)
    first = torch.nonzero(full.emit)[:24, 0]
    assert torch.equal(res.rows[:, 0].long(), first)


def test_failed_batch_capture_raises_and_keeps_nothing(cpu_graphs,
                                                       monkeypatch):
    """A key's second batch captures; a capture that fails raises out of
    submit_call_batch, no graph is kept and no eager step scores the
    batch in its place."""
    def broken(step, stream, pool):
        step()
        raise RuntimeError("capture failed")

    graphs = sg.SlabStepGraph(capture=broken, device_types=("cpu",))
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    params = ModelParams()
    dtabs = device_tables(build_tables(params), CPU)
    batch, ref16 = _batch(100, 16, 1, True)
    runner.submit_call_batch(batch, ref16, dtabs, CPU)
    gk.reset_launches()
    with pytest.raises(RuntimeError, match="capture failed"):
        runner.submit_call_batch(batch, ref16, dtabs, CPU)
    assert graphs.captures() == {}
    assert sum(gk.LAUNCHES.values()) == 0
    assert _routes() == {"batches_eager_first": 1}
