"""The port's ``utils.mfu`` against the JAX package's on the CPU.

The counts: ``flops_per_pair_column`` is the source's, unchanged; the
port's own count is linear in depth.  ``bench_kernel`` runs on the CPU by
name and fills every field.  The data: the arrays it scores equal those
the JAX ``bench_kernel`` builds for the same B and D (caught where that
function hands them to ``jnp.asarray``), and the port's
``call_batch_packed`` on them gives the same count and the same rows as
the JAX package's, and ``call_batch`` the same fields for every column
(XLA backend, i32 rows; no tolerance).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import f32_tables  # noqa: E402

from somatic_sniper_tpu.models import glfgen as jg  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.utils import mfu as jmfu  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402
from somatic_sniper_tpu_torch.utils import mfu  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("D", [16, 32, 64, 255, 300])
def test_source_flop_count_is_unchanged(D):
    assert mfu.flops_per_pair_column(D) == jmfu.flops_per_pair_column(D)


def test_port_flop_count_is_linear_in_depth():
    f = {D: mfu.port_flops_per_pair_column(D) for D in (16, 32, 64, 128)}
    assert f[16] < f[32] < f[64] < f[128]
    # equal steps for equal steps of depth: 6 f32 operations a lane pair
    assert f[32] - f[16] == 6 * 16 and f[128] - f[64] == 6 * 64
    assert f[64] / f[32] < 1.2 < 3.0 < (mfu.flops_per_pair_column(64)
                                        / mfu.flops_per_pair_column(32))


def test_byte_count_follows_the_row_layout():
    assert mfu.ROW_WORDS == 1 + len(ts.COMPACT_FIELDS) + 36
    assert mfu.hbm_bytes_per_pair_column(48) \
        == 2 * 4 * 48 + 12 + 4 * mfu.ROW_WORDS
    # the rows the step writes are that wide
    stacked, meta = mfu.bench_inputs(8, 4)
    res = ts.call_batch_packed(
        torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta),
        device_tables(build_tables(ModelParams()), CPU), ModelParams())
    assert res.rows.shape == (8, mfu.ROW_WORDS)


def test_peaks_are_the_h100s():
    assert mfu.H100_PEAK_F32_FLOPS == 67e12
    assert mfu.H100_HBM_BYTES_PER_S == 3.35e12
    assert not [n for n in dir(mfu) if n.startswith(("V5E", "TPU"))]


def test_bench_kernel_runs_on_cpu():
    gk.reset_launches()
    r = mfu.bench_kernel(B=128, D=16, iters=4, device="cpu")
    assert r.cols_per_sec > 0 and r.measured_slab_s > 0
    assert r.flops_per_col == mfu.flops_per_pair_column(16)
    assert r.port_flops_per_col == mfu.port_flops_per_pair_column(16)
    assert r.tflops == pytest.approx(
        r.cols_per_sec * r.port_flops_per_col / 1e12)
    assert r.est_mfu == pytest.approx(r.tflops * 1e12 / 67e12)
    assert r.bound_compute_s == pytest.approx(128 * r.port_flops_per_col
                                              / 67e12)
    assert r.bound_hbm_s == pytest.approx(
        128 * mfu.hbm_bytes_per_pair_column(16) / 3.35e12)
    assert (r.B, r.D) == (128, 16)
    # the CPU launches nothing: no kernel count, no floor, no launch bound
    assert r.launches_per_step > 100 and r.kernel_launches == {}
    assert r.launch_floor_s == 0.0 and r.bound_launch_s == 0.0
    assert r.stream_launch_floor_s == 0.0 and r.graph_run_s == 0.0
    assert (r.eager_slab_s, r.eager_host_queue_s) == (r.measured_slab_s,
                                                      r.host_queue_s)
    assert 0 < r.host_queue_s < 10 * r.measured_slab_s
    # a warm step, a counted one, two timings each of 2 and 4, and 4 more
    assert r.steps_run == 2 + 2 * (2 + 4) + 4
    assert not any(gk.LAUNCHES.values())
    assert r.verdict.startswith("cpu run") and "H100" in r.verdict
    assert all(v is not None for v in r)


def test_bench_kernel_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mfu.bench_kernel(B=8, D=4, iters=4)


@pytest.mark.parametrize("slab_s,want", [
    (2e-3, "launch"), (3e-6, "byte"), (4e-7, "f32")])
def test_verdict_names_the_closest_bound(slab_s, want):
    bounds = {"launch": 1e-3, "byte": 2e-6, "f32": 5e-7}
    v = mfu._verdict(slab_s, bounds)
    assert v.startswith(f"{want}-bound") and "waits for the host" not in v
    assert "waits for the host" in mfu._verdict(slab_s, bounds, 0.9 * slab_s)


def test_count_step_ops_leaves_out_views_and_allocations():
    x = torch.arange(12, dtype=torch.int32)

    def step():
        y = x.view(3, 4)[1:]          # two views
        z = torch.empty_like(y)       # an allocation
        z.copy_(y + 1)                # an add and a copy
        return int(z.sum())           # a sum and a scalar read

    assert mfu.count_step_ops(step) == 3


def test_inputs_and_rows_equal_the_jax_package(monkeypatch):
    """The same data in both packages: the arrays of mfu.py:113-137, and
    the scoring step's count and emitted rows on them."""
    B, D = 128, 16
    seen = []
    real = jnp.asarray

    def spy(a, *args, **kw):
        if isinstance(a, np.ndarray) and a.ndim >= 2:
            seen.append(np.array(a))
        return real(a, *args, **kw)

    monkeypatch.setattr(jnp, "asarray", spy)
    jmfu.bench_kernel(B=B, D=D, iters=4)
    monkeypatch.setattr(jnp, "asarray", real)
    stacked_j = next(a for a in seen if a.shape == (2, B, D))
    meta_j = next(a for a in seen if a.shape == (3, B))
    stacked, meta = mfu.bench_inputs(B, D)
    assert stacked.dtype == stacked_j.dtype == np.uint32
    assert meta.dtype == meta_j.dtype == np.int32
    np.testing.assert_array_equal(stacked, stacked_j)
    np.testing.assert_array_equal(meta, meta_j)

    params = T.ModelParams()
    tabs = T.build_tables(params)
    fk, coef, lhet = f32_tables(tabs)
    tables = (fk, coef, lhet, tabs.solo_prior, tabs.joint_prior, tabs.qadd,
              tabs.q_r_int)
    kw = dict(use_joint=False, min_somatic_qual=params.min_somatic_qual,
              include_loh=params.include_loh, include_gor=params.include_gor,
              cap_mapq=params.cap_mapq, theta=params.theta, eta=params.eta,
              glf_backend="xla")
    want = js.call_batch_packed(jnp.asarray(stacked), jnp.asarray(meta),
                                *tables, max_emit=B, row_dtype="i32", **kw)
    s_t, m_t = torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta)
    dtabs = device_tables(build_tables(ModelParams()), CPU)
    got = ts.call_batch_packed(s_t, m_t, dtabs, ModelParams())
    # tumor and normal differ in one baseQ bit, so no site is emitted:
    # the counts are 0 and every row repeats column 0, in both packages
    assert int(got.count) == int(want.count) == 0
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    # so hold every column's full result too, dqstats rows included
    cb_t, cb_n = ts.packed_column_batches(s_t, m_t)
    full = ts.call_batch(cb_t, cb_n, dtabs, ModelParams())
    jcb = [jg.ColumnBatch(slots=jnp.asarray(c.slots.numpy().view(np.uint32)),
                          depth=jnp.asarray(c.depth.numpy()),
                          ref16=jnp.asarray(c.ref16.numpy()),
                          n_keep=jnp.asarray(c.n_keep.numpy()))
           for c in (cb_t, cb_n)]
    jfull = js.call_batch(*jcb, *tables, precision="fast", dq=True, **kw)
    for name in jfull._fields:
        np.testing.assert_array_equal(
            getattr(full, name).numpy().astype(np.int64),
            np.asarray(getattr(jfull, name)).astype(np.int64), name)
    assert int(full.tumor_depth.min()) >= D // 2
