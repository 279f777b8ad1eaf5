"""The port's batch split over devices (``parallel/sharding.py``), the
production hook (``runner.data_mesh``) and the dry run.

A split batch must equal the unsplit call in every field with no
tolerance (columns never interact), whatever the number of parts and
whether or not it divides the batch.  Against the JAX package's
``sharded_call_batch`` on its 8 virtual CPU devices, calls and emission
are equal and the scores that pass through f32 class sums within +/-1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (f32_tables, port_params,  # noqa: E402
                                   random_raw32, random_stacked, random_u32,
                                   to_packed16)

from somatic_sniper_tpu.models import glfgen as jg  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.parallel import sharding as jsharding  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.glfgen import ColumnBatch  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    ModelParams, build_tables, device_tables)
from somatic_sniper_tpu_torch.parallel import sharding  # noqa: E402
from somatic_sniper_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip, mesh_devices)
from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch  # noqa: E402
from somatic_sniper_tpu_torch.utils.stats import STATS  # noqa: E402

CPU = torch.device("cpu")
PM1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
       "somatic_score", "joint_cnsq")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _batches(encoding, B, D, seed):
    """(tumor, normal) ColumnBatches on the host in one encoding."""
    if encoding == "raw32":
        s_t, nk_t, d_t, ref16 = random_raw32(B, D, seed)
        s_n, nk_n, d_n, _ = random_raw32(B, D, seed + 1000)
        r = torch.from_numpy(ref16)
        return (ColumnBatch(_i32(s_t), torch.from_numpy(d_t), r,
                            torch.from_numpy(nk_t)),
                ColumnBatch(_i32(s_n), torch.from_numpy(d_n), r,
                            torch.from_numpy(nk_n)))
    s_t, d_t, ref16 = random_u32(B, D, seed)
    s_n, d_n, _ = random_u32(B, D, seed + 1000)
    r = torch.from_numpy(ref16)
    if encoding == "u32":
        return (ColumnBatch(_i32(s_t), torch.from_numpy(d_t), r),
                ColumnBatch(_i32(s_n), torch.from_numpy(d_n), r))
    out = []
    for s, d in ((s_t, d_t), (s_n, d_n)):
        s16, nk, rms = to_packed16(s, d, ref16)
        out.append(ColumnBatch(torch.from_numpy(s16), torch.from_numpy(d), r,
                               torch.from_numpy(nk), torch.from_numpy(rms)))
    return tuple(out)


def _assert_equal_results(got, want):
    for name, a, b in zip(want._fields, got, want):
        if b is None:
            assert a is None, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("B", [48, 53], ids=["divides", "uneven"])
@pytest.mark.parametrize("encoding", ["u32", "raw32", "u16"])
def test_split_equals_unsplit(encoding, B, n):
    params = ModelParams(use_joint_priors=True, min_somatic_qual=0)
    tumor, normal = _batches(encoding, B, 24, seed=7 + n)
    want = ts.call_batch(tumor, normal,
                         device_tables(build_tables(params), CPU), params)
    got = sharding.sharded_call_batch([CPU] * n, tumor, normal,
                                      runner.dtabs_for(params, "fast"),
                                      params)
    _assert_equal_results(got, want)
    assert got.emit.shape == (B,) and int(got.emit.sum()) > 0
    assert (got.tumor_dq is not None) == (encoding == "raw32")


@pytest.mark.parametrize("B,n", [(5, 8), (0, 3), (20, 3)],
                         ids=["fewer-columns-than-parts", "empty", "exact"])
def test_split_edge_cases(B, n):
    """Parts may be empty; an empty batch stays empty; the exact f64
    glfgen splits like the fast one."""
    precision = "exact" if B == 20 else "fast"
    params = ModelParams(min_somatic_qual=0)
    tumor, normal = _batches("u32", B, 12, seed=3)
    want = ts.call_batch(
        tumor, normal, device_tables(build_tables(params), CPU, precision),
        params, precision)
    got = sharding.sharded_call_batch(
        [CPU] * n, tumor, normal, runner.dtabs_for(params, precision), params,
        precision)
    _assert_equal_results(got, want)
    assert sharding.split_bounds(5, 3) == [(0, 1), (1, 3), (3, 5)]
    with pytest.raises(ValueError, match="no devices"):
        sharding.sharded_call_batch([], tumor, normal, None, params)


@pytest.mark.parametrize("use_joint", [False, True], ids=["solo", "joint"])
def test_split_against_the_jax_mesh(use_joint):
    """The JAX package's sharded_call_batch over its 8 virtual devices
    (full u32 batches, the XLA accumulate) on the same inputs."""
    B, D = 64, 24
    s_t, d_t, ref16 = random_u32(B, D, seed=11)
    s_n, d_n, _ = random_u32(B, D, seed=12)
    jparams = T.ModelParams(use_joint_priors=use_joint,
                            somatic_mutation_rate=0.001, min_somatic_qual=0)
    tabs = T.build_tables(jparams)
    mesh = jsharding.make_mesh(8)
    assert mesh.size == 8 == len(jax.devices())
    want = jsharding.sharded_call_batch(
        mesh,
        jg.ColumnBatch(jnp.asarray(s_t), jnp.asarray(d_t), jnp.asarray(ref16)),
        jg.ColumnBatch(jnp.asarray(s_n), jnp.asarray(d_n), jnp.asarray(ref16)),
        (*f32_tables(tabs), tabs.solo_prior, tabs.joint_prior, tabs.qadd,
         tabs.q_r_int),
        precision="fast", use_joint=use_joint, min_somatic_qual=0,
        glf_backend="xla")
    params = port_params(jparams)
    r = torch.from_numpy(ref16)
    got = sharding.sharded_call_batch(
        [CPU] * 8, ColumnBatch(_i32(s_t), torch.from_numpy(d_t), r),
        ColumnBatch(_i32(s_n), torch.from_numpy(d_n), r),
        runner.dtabs_for(params, "fast"), params)
    for f in js.COMPACT_FIELDS + ("emit",):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if f in PM1:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(got.emit.sum()) > 4


def test_partition_intervals_equals_the_jax_one():
    for lens in ([1000, 10, 3000], [3], [3000, 2000], [7, 7, 7, 7]):
        for n in (1, 2, 5, 7, 8):
            got = sharding.partition_intervals(lens, n)
            assert got == jsharding.partition_intervals(lens, n)
            assert len(got) == n
            assert sum(hi - lo for sh in got for _t, lo, hi in sh) \
                == sum(lens)


def test_dryrun_multichip_on_cpu_parts(capsys):
    dryrun_multichip(4, "cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: 4 devices (cpu)" in out
    assert "e2e records 3" in out
    # anything but "cpu" by name asks for that many GPUs
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="GPUs"):
        mesh_devices(have + 1, "cuda")


def test_data_mesh_policy(monkeypatch):
    assert runner.data_mesh(CPU) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert runner.data_mesh(CPU) is None
    assert runner.data_mesh(torch.device("cuda", 0)) == [
        torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("SNIPER_NO_MESH", "1")
    assert runner.data_mesh(torch.device("cuda", 0)) is None
    monkeypatch.delenv("SNIPER_NO_MESH")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runner.data_mesh(torch.device("cuda", 0)) is None
    with runner.forced_mesh([CPU, CPU]):
        assert runner.data_mesh(CPU) == [CPU, CPU]
    assert runner.data_mesh(CPU) is None


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("packed16", [True, False], ids=["u16", "u32"])
def test_submit_call_batch_under_a_mesh(packed16, n):
    """The production hook on the CPU: a batch of 53 columns, padded to
    its bucket of 256, dispatched under a mesh of three parts (which
    does not divide the bucket: unsplit, as the JAX package leaves it)
    or four (split by the eager ``sharded_call_batch``), compacts to the
    rows of the unsplit dispatch, and the full result is equal too."""
    B, D = 53, 24
    stacked, meta = random_stacked(B, D, 5, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    batch = PairedBatch(keys=np.arange(B, dtype=np.int64), ref16=meta[2],
                        tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                        n_normal=meta[1], **extra)
    assert batch.packed16 == packed16
    params = ModelParams(min_somatic_qual=0)
    dtabs = device_tables(build_tables(params), CPU)
    want = runner.submit_call_batch(batch, meta[2], dtabs, CPU)
    full = runner.submit_call_batch(batch, meta[2], dtabs, CPU,
                                    compact=False)
    STATS.reset()
    with runner.forced_mesh([CPU] * n):
        got = runner.submit_call_batch(batch, meta[2], dtabs, CPU)
        got_full = runner.submit_call_batch(batch, meta[2], dtabs, CPU,
                                            compact=False)
    snap = STATS.snapshot()
    assert snap.get("batches_eager_cpu") == 1
    assert snap.get("batches_unsplit" if n == 3 else "batches_split") == 1
    assert int(got.count) == int(want.count) > 0
    assert torch.equal(got.rows, want.rows)
    _assert_equal_results(got_full, full)
