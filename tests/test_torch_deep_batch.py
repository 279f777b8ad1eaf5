"""The captured deep fast batch and its error word, on the CPU.

A fast batch deeper than 255 takes its key's captured step: the
accumulate, the c_tot > 255 rescale and the stand-alone assembly, whose
error word stays on the device; ``runner.collect_pending`` reads it
with the counts and raises the stand-alone ``assembly10``'s ValueError.
A direct call of a public scoring function sets the word and never
raises.

A CUDA graph exists only on a card; here a registry that captures on
the CPU with the eager step standing in for the replay
(``tests/torch_port_util.eager_stand_in``) runs the routes.  The rows
are held to the eager step exactly and to the JAX package's
``call_batch_stacked`` under the fast contract (+/-1, 99% of rows
equal), as tests/test_torch_batch_graph.py states it.  The card's
graphs are held to the eager step in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_port_util import (eager_stand_in,  # noqa: E402
                                   held_to_jax, jax_call_batch_stacked,
                                   paired_batch, port_params, random_slab)

from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as mg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import step_graph as sg  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")
JPARAMS = JT.ModelParams(min_somatic_qual=0)
PARAMS = port_params(JPARAMS)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A registry that captures on the CPU in place of the process's."""
    graphs = sg.SlabStepGraph(capture=eager_stand_in, device_types=("cpu",))
    monkeypatch.setattr(sg, "STEP_GRAPHS", graphs)
    STATS.reset()
    yield graphs
    STATS.reset()


def _eager(padded, packed16, dtabs, precision, max_emit):
    """The eager batch step on the padded upload."""
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
            if k.startswith(("batches_", "batch_captures"))}


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


@pytest.mark.parametrize("route", ["graph", "cpu-eager"])
def test_deep_fast_batch_and_its_error_word(cpu_graphs, monkeypatch, poison,
                                            route):
    """A fast batch of depth 300 (the accumulate, the c_tot > 255
    rescale, the stand-alone assembly) through its key's captured step,
    or on the CPU's eager route: the
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

    def submit(seed):
        batch, ref16, padded = paired_batch(200, D, seed, False)
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
    want = jax_call_batch_stacked(padded, False, "fast", JPARAMS)
    assert int(want.count) == n_rows
    held_to_jax(res.rows[:n_rows].numpy(), np.asarray(want.rows)[:n_rows],
                False)
    assert _bytes(res) == _bytes(_eager(padded, False, dtabs, "fast",
                                        runner.MAX_EMIT))
    poison[0, 0] = -1000
    bad_replay, _ = submit(3)
    with pytest.raises(ValueError, match=message):
        collect(good + bad_replay)
    if route == "cpu-eager":
        assert _routes() == {"batches_eager_cpu": 3}
        return
    assert _routes()["batches_graphed"] == 2
    assert len(cpu_graphs.captures()) == 1


@pytest.mark.parametrize("entry", ["glfgen_batch", "call_batch",
                                   "stacked-full", "stacked-compact"])
def test_direct_deep_call_sets_the_error_word(poison, entry):
    """A direct call of a public scoring function on a fast batch of
    depth 300 never raises on an out-of-table count: it sets the error
    word, which is 0 on the same inputs in the tables, and the column
    pushed out gets zero likelihoods."""
    dtabs = device_tables(build_tables(PARAMS), CPU)
    _, _, (stacked, meta) = paired_batch(40, 300, 8, False)
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
    batch, ref16, _ = paired_batch(40, 300, 7, False)
    good = runner.run_call_batch(batch, ref16, dtabs, CPU)
    assert good.err is None and int(good.emit.sum()) > 0
    poison[0, 2] = 999
    with pytest.raises(ValueError, match="table depth"):
        runner.run_call_batch(batch, ref16, dtabs, CPU)


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
