"""The captured slab step (models/step_graph.py) on the CPU.

A CUDA graph exists only on a card; here the eager step stands in for
the replay, so what is held is what surrounds the graph: no tensor of a
warm step is made from host data (a capture forbids the copy), the key
and the reuse of a captured step, the launch counts (the warm-up and
the capture are left out, each replay adds the capture's), a second
input set after the first, a failed capture, and the dispatcher's one
slab in flight.  The rows are held to the JAX package's
``call_batch_packed`` under the fast contract (tests/test_torch_somatic
.py), and to the eager step exactly.  The card's own graph is held to
the eager step in tests/test_torch_cuda.py.

Also here: the native host libraries that the repository's root
``conftest.py`` builds before the test workers start.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (eager_stand_in,  # noqa: E402
                                   f32_tables, held_to_jax, port_params,
                                   random_slab)

from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as mg  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models import step_graph as sg  # noqa: E402
from somatic_sniper_tpu_torch.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def counted_glfgen32(monkeypatch):
    """glfgen32 counting a launch as the card's wrapper does (on the CPU
    the wrapper runs the plain version and counts nothing)."""
    def glfgen32(*args):
        gk.LAUNCHES["glfgen32"] += 1
        return gk.glfgen32(*args)

    monkeypatch.setattr(mg, "glfgen32", glfgen32)
    gk.reset_launches()
    yield
    gk.reset_launches()


def _eager(stacked, meta, dtabs, params):
    res = ts.call_batch_packed(torch.from_numpy(stacked.view(np.int32)),
                               torch.from_numpy(meta), dtabs, params)
    n = int(res.count)
    return n, res.rows[:n].numpy()


@pytest.mark.parametrize("use_joint", [False, True])
def test_warm_step_makes_no_tensor_from_host_data(use_joint):
    """A capturing stream forbids the pageable copy that a tensor made
    from Python or numpy data needs (``lift_fresh``): a warm step makes
    none."""
    from torch.utils._python_dispatch import TorchDispatchMode

    params = T.ModelParams(use_joint_priors=use_joint)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    stacked, meta = random_slab(64, 16, 5)
    s, m = torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta)
    ts.call_batch_packed(s, m, dtabs, params)  # warm

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    with Ops():
        ts.call_batch_packed(s, m, dtabs, params)
    assert len(seen) > 1000
    assert not [n for n in seen if "lift_fresh" in n]


def test_key_tells_shapes_params_and_tables_apart():
    p0, p1 = T.ModelParams(), T.ModelParams(use_joint_priors=True)
    d0 = T.device_tables(T.build_tables(p0), CPU)
    d1 = T.device_tables(T.build_tables(p1), CPU)
    key = sg.SlabStepGraph.key
    base = key("cpu", 8192, 48, p0, d0)
    assert base == key(CPU, 8192, 48, T.ModelParams(), d0)
    others = [key("cpu", 4096, 48, p0, d0), key("cpu", 8192, 64, p0, d0),
              key("cpu", 8192, 48, p1, d0), key("cpu", 8192, 48, p0, d1),
              key("meta", 8192, 48, p0, d0)]
    assert len({base, *others}) == 6


@pytest.mark.parametrize("D,use_joint", [(16, False), (48, True)])
def test_replays_count_launches_and_take_new_inputs(counted_glfgen32, D,
                                                   use_joint):
    """Two input sets back to back through one captured step, then a
    second depth: each answer is the eager step's on its own inputs
    (no stale static buffer), each replay counts two glfgen32 launches,
    and the warm-up steps and the capture count none."""
    params = T.ModelParams(use_joint_priors=use_joint, min_somatic_qual=0)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    graphs = sg.SlabStepGraph(capture=eager_stand_in)
    B = 128
    for i, seed in enumerate((1, 2)):
        stacked, meta = random_slab(B, D, seed)
        want = _eager(stacked, meta, dtabs, params)
        gk.reset_launches()
        n, rows = graphs.run(stacked, meta, dtabs, params, CPU)
        assert gk.LAUNCHES["glfgen32"] == 2, i
        assert n == want[0] > 0
        np.testing.assert_array_equal(rows, want[1])
    (key, step), = graphs._steps.items()
    assert key == graphs.key(CPU, B, D, params, dtabs)
    assert step.launches == {"glfgen32": 2}
    assert list(graphs.captures()) == [key]
    graphs.run(*random_slab(B, D + 1, 3), dtabs, params, CPU)
    assert len(graphs.captures()) == 2
    assert sum(gk.LAUNCHES.values()) == 2 + 2


def test_step_rows_match_jax(counted_glfgen32):
    """Slabs through the captured step against the JAX package's jitted
    ``call_batch_packed`` on the same inputs: count equal, the rows
    within the fast contract."""
    B, D = 256, 48
    params = T.ModelParams(min_somatic_qual=0)
    jparams = JT.ModelParams(min_somatic_qual=0)
    tabs = JT.build_tables(jparams)
    fk, coef, lhet = f32_tables(tabs)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    graphs = sg.SlabStepGraph(capture=eager_stand_in)
    for seed in (11, 12):
        stacked, meta = random_slab(B, D, seed)
        want = js.call_batch_packed(
            jnp.asarray(stacked), jnp.asarray(meta), fk, coef, lhet,
            tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
            use_joint=False, min_somatic_qual=0, include_loh=True,
            include_gor=True, cap_mapq=60, theta=params.theta,
            eta=params.eta, max_emit=B, glf_backend="xla", row_dtype="i32")
        n, rows = graphs.run(stacked, meta, dtabs, params, CPU)
        assert n == int(want.count) > B // 8
        rows_w = np.asarray(want.rows)[:n].astype(int)
        assert np.abs(rows.astype(int) - rows_w).max() <= 1
        assert (rows == rows_w).all(axis=1).mean() >= 0.99


def test_failed_capture_raises_and_keeps_nothing(counted_glfgen32):
    def broken(step, stream, pool):
        step()
        raise RuntimeError("capture failed")

    params = T.ModelParams()
    dtabs = T.device_tables(T.build_tables(params), CPU)
    graphs = sg.SlabStepGraph(capture=broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.run(*random_slab(64, 16, 4), dtabs, params, CPU)
    assert graphs.captures() == {}
    assert sum(gk.LAUNCHES.values()) == 0


def test_dispatcher_scores_one_slab_at_a_time(monkeypatch):
    """The captured step's buffers serve one slab at a time; the
    dispatcher asserts it, and on the CPU it scores eagerly."""
    from somatic_sniper_tpu_torch.parallel.slab import TorchSlabDispatcher

    def no_graph(*args):
        raise AssertionError("the CPU took the captured step")

    monkeypatch.setattr(sg.STEP_GRAPHS, "run", no_graph)
    params = T.ModelParams(min_somatic_qual=0)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    disp = TorchSlabDispatcher(lambda: dtabs, T.build_tables(params),
                               params, None, CPU)
    stacked, meta = random_slab(128, 16, 6)
    assert disp._dispatch_and_fetch(stacked, meta)[0] == \
        _eager(stacked, meta, dtabs, params)[0]
    with disp._in_flight:
        with pytest.raises(AssertionError, match="second slab in flight"):
            disp._dispatch_and_fetch(stacked, meta)
    disp._collector.shutdown()


@pytest.mark.parametrize("D", [16, 32, 48, 128, 255])
@pytest.mark.parametrize("B", [96, 100])
def test_slab_rows_equal_jax(monkeypatch, B, D):
    """Two slabs through a dispatcher on a registry that captures on the
    CPU: the first captured after its warm-up steps, the second
    replayed, both counted as graphed; the rows byte-equal to the eager
    step's and within the fast contract of the JAX package's
    ``call_batch_packed``."""
    from somatic_sniper_tpu_torch.parallel import slab
    from somatic_sniper_tpu_torch.utils.stats import STATS

    graphs = sg.SlabStepGraph(capture=eager_stand_in, device_types=("cpu",))
    monkeypatch.setattr(slab, "STEP_GRAPHS", graphs)
    jparams = JT.ModelParams(min_somatic_qual=0)
    params = port_params(jparams)
    dtabs = T.device_tables(T.build_tables(params), CPU)
    tabs = JT.build_tables(jparams)
    fk, coef, lhet = f32_tables(tabs)
    disp = slab.TorchSlabDispatcher(lambda: dtabs, T.build_tables(params),
                                    params, None, CPU)
    STATS.reset()
    try:
        for seed in (1, 2):
            stacked, meta = random_slab(B, D, 50 + seed + D)
            n, rows = disp._dispatch_and_fetch(stacked, meta)
            want = _eager(stacked, meta, dtabs, params)
            assert n == want[0] > B // 8
            assert rows.tobytes() == want[1].tobytes()
            jw = js.call_batch_packed(
                jnp.asarray(stacked), jnp.asarray(meta), fk, coef, lhet,
                tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
                use_joint=False, min_somatic_qual=0, include_loh=True,
                include_gor=True, cap_mapq=60, theta=params.theta,
                eta=params.eta, max_emit=B, glf_backend="xla",
                row_dtype="i32")
            assert int(jw.count) == n
            held_to_jax(rows, np.asarray(jw.rows)[:n], False)
        snap = STATS.snapshot()
        assert snap["slabs_graphed"] == 2 == snap[f"slabs_at_depth_{D}"]
        assert list(graphs.captures()) == [graphs.key(CPU, B, D, params,
                                                      dtabs)]
    finally:
        disp._collector.shutdown()
        STATS.reset()


def test_failed_slab_capture_in_the_dispatcher(monkeypatch):
    """A slab whose key fails to capture raises out of the dispatcher's
    fetch, no graph is kept, and the next slab of the key tries the
    capture again: nothing scores a slab eagerly in its place."""
    from somatic_sniper_tpu_torch.parallel import slab

    tries = []

    def broken(step, stream, pool):
        tries.append(1)
        step()
        raise RuntimeError("capture failed")

    graphs = sg.SlabStepGraph(capture=broken, device_types=("cpu",))
    monkeypatch.setattr(slab, "STEP_GRAPHS", graphs)
    params = T.ModelParams()
    dtabs = T.device_tables(T.build_tables(params), CPU)
    disp = slab.TorchSlabDispatcher(lambda: dtabs, T.build_tables(params),
                                    params, None, CPU)
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError, match="capture failed"):
                disp._dispatch_and_fetch(*random_slab(64, 16, 4))
            assert graphs.captures() == {}
        assert len(tries) == 2
    finally:
        disp._collector.shutdown()


def test_native_libraries_load_in_a_worker():
    """Both host libraries load in a test process: the root conftest
    built them whole before the workers started."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither library can be built")
    from somatic_sniper_tpu.io import native as jax_native
    from somatic_sniper_tpu_torch.io import native as torch_native

    assert jax_native.get_lib() is not None
    assert torch_native.get_lib() is not None


@pytest.mark.parametrize("worker", [False, True])
def test_root_conftest_builds_in_the_controller_only(monkeypatch, worker):
    from somatic_sniper_tpu.io import native as jax_native
    from somatic_sniper_tpu_torch.io import native as torch_native

    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  REPO / "conftest.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    called = []
    for m in (jax_native, torch_native):
        monkeypatch.setattr(m, "get_lib",
                            lambda m=m: called.append(m.__name__))

    class Config:
        pass

    config = Config()
    if worker:
        config.workerinput = {"workerid": "gw0"}
    root.pytest_configure(config)
    assert sorted(called) == ([] if worker else sorted(
        [jax_native.__name__, torch_native.__name__]))
