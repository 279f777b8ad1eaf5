"""The eager batch step on one device and its compaction, on the CPU.

``models.somatic.call_batch`` scores a batch in any of its three
encodings (full u32 slot words, raw kept-only u32 lanes with the
dqstats rows, compact u16 lanes) on the one device it lies on.  The
batch path pads a batch to its bucket (``runner._b_bucket``) with empty
columns: the padded call, cut back to the batch, equals the unpadded
call in every field with no tolerance, and the unpadded call meets the
JAX package's ``call_batch`` on the same inputs (calls, statuses,
depths and dqstats equal; the phred fields within +/-1, 99% of the
columns equal).

``compact_rows`` is held to a plain statement of the compaction: the
emitted columns' rows in column order, ``count`` of them, at most K =
min(max_emit, B) kept, the rows past ``count`` repeating column 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (PM1, f32_tables,  # noqa: E402
                                   port_params, random_raw32, random_u32,
                                   to_packed16)

from somatic_sniper_tpu.models import glfgen as jg  # noqa: E402
from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as JT  # noqa: E402
from somatic_sniper_tpu_torch import runner  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.glfgen import ColumnBatch  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    build_tables, device_tables)

CPU = torch.device("cpu")
JPARAMS = JT.ModelParams(use_joint_priors=True, somatic_mutation_rate=0.001,
                         min_somatic_qual=0)
PARAMS = port_params(JPARAMS)


def _host_batches(encoding, B, D, seed):
    """(tumor, normal) as lists of numpy arrays in one encoding, the
    fields of ``ColumnBatch`` in order."""
    if encoding == "raw32":
        s_t, nk_t, d_t, ref16 = random_raw32(B, D, seed)
        s_n, nk_n, d_n, _ = random_raw32(B, D, seed + 1000)
        return ([s_t, d_t, ref16, nk_t], [s_n, d_n, ref16, nk_n])
    s_t, d_t, ref16 = random_u32(B, D, seed)
    s_n, d_n, _ = random_u32(B, D, seed + 1000)
    if encoding == "u32":
        return ([s_t, d_t, ref16], [s_n, d_n, ref16])
    out = []
    for s, d in ((s_t, d_t), (s_n, d_n)):
        s16, nk, rms = to_packed16(s, d, ref16)
        out.append([s16, d, ref16, nk, rms])
    return tuple(out)


def _port_batch(fields, B=None):
    """A port ColumnBatch of host fields, padded to B columns with empty
    ones where B is given (as ``runner._pad_b`` pads an upload)."""
    out = []
    for a in fields:
        a = a if B is None else runner._pad_b(a, B)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(np.ascontiguousarray(a)))
    return ColumnBatch(*out)


@pytest.mark.parametrize("B", [0, 1, 5, 20, 48, 53, 300, 4100])
@pytest.mark.parametrize("encoding", ["u32", "raw32", "u16"])
def test_batch_equals_jax(encoding, B):
    D = 24
    tumor, normal = _host_batches(encoding, B, D, seed=7 + B)
    dtabs = device_tables(build_tables(PARAMS), CPU)
    got = ts.call_batch(_port_batch(tumor), _port_batch(normal), dtabs,
                        PARAMS)
    bucket = runner._b_bucket(B)
    padded = ts.call_batch(_port_batch(tumor, bucket),
                           _port_batch(normal, bucket), dtabs, PARAMS)
    assert padded.emit.shape == (bucket,)
    assert not padded.emit[B:].any()
    for name, a, b in zip(got._fields, padded, got):
        assert (a is None) == (b is None), name
        if b is not None and name != "err":
            assert a.dtype == b.dtype and torch.equal(a[:B], b), name
    raw = encoding == "raw32"
    assert (got.tumor_dq is not None) == raw
    assert got.emit.shape == (B,) and got.emit.dtype == torch.bool
    if B == 0:
        # an empty result of the dtypes of a full one
        one = ts.call_batch(_port_batch(_host_batches(encoding, 1, D, 1)[0]),
                            _port_batch(_host_batches(encoding, 1, D, 1)[1]),
                            dtabs, PARAMS)
        for name, a, b in zip(got._fields, got, one):
            if b is not None and name != "err":
                assert a.dtype == b.dtype and a.shape[1:] == b.shape[1:], name
                assert a.shape[0] == 0, name
        return

    tabs = JT.build_tables(JPARAMS)

    def jbatch(fields):
        return jg.ColumnBatch(*(jnp.asarray(a) for a in fields))

    want = js.call_batch(
        jbatch(tumor), jbatch(normal), *f32_tables(tabs), tabs.solo_prior,
        tabs.joint_prior, tabs.qadd, tabs.q_r_int, precision="fast",
        use_joint=True, min_somatic_qual=0, cap_mapq=JPARAMS.cap_mapq,
        theta=JPARAMS.theta, eta=JPARAMS.eta, glf_backend="xla", dq=raw)
    same = np.ones(B, bool)
    for f in js.COMPACT_FIELDS + ("emit", "tumor_depth", "normal_depth",
                                  "tumor_dq", "normal_dq"):
        if getattr(want, f) is None:
            assert not raw and getattr(got, f) is None, f
            continue
        a = getattr(got, f).numpy().astype(int)
        b = np.asarray(getattr(want, f)).astype(int)
        if f in PM1:
            assert np.abs(a - b).max() <= 1, f
            same &= a == b
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert same.mean() >= 0.99


def _compact_plain(emit, fields, dq_t, dq_n, max_emit):
    """The compaction as a statement: (count, rows [K, 1 + F + 36])."""
    B = len(emit)
    K = min(max_emit, B)
    idx = np.nonzero(emit)[0][:K]
    idx = np.concatenate([idx, np.zeros(K - len(idx), np.int64)])
    rows = np.concatenate([idx[:, None], fields[idx], dq_t[idx], dq_n[idx]],
                          axis=1)
    return int(emit.sum()), rows.astype(np.int32)


@pytest.mark.parametrize("B,max_emit,p_emit", [
    (64, 64, 0.3), (64, 64, 0.0), (64, 64, 1.0), (96, 10, 0.5),
    (64, 5, 0.9), (256, 40, 0.2), (64, 64, "col0-only"),
    (96, 96, "not-col0")])
def test_compact_rows_equal_the_plain_statement(B, max_emit, p_emit):
    """None emitted, all emitted, more emitted than the K rows hold,
    column 0 emitted alone or not at all: every row byte for byte, the
    count, and no error word."""
    rng = np.random.default_rng(B + max_emit)
    if p_emit == "col0-only":
        emit = np.zeros(B, bool)
        emit[0] = True
    elif p_emit == "not-col0":
        emit = rng.random(B) < 0.6
        emit[0] = False
    else:
        emit = rng.random(B) < p_emit
    names = [n for n in ts.CallResult._fields
             if n not in ("emit", "tumor_dq", "normal_dq", "err")]
    cols = {n: rng.integers(0, 255, B).astype(np.int32) for n in names}
    dq_t = rng.integers(0, 99, (B, 18)).astype(np.int32)
    dq_n = dq_t + 1
    res = ts.CallResult(
        emit=torch.from_numpy(emit), tumor_dq=torch.from_numpy(dq_t),
        normal_dq=torch.from_numpy(dq_n),
        **{n: torch.from_numpy(v) for n, v in cols.items()})
    got = ts.compact_rows(res, max_emit)
    fields = np.stack([cols[f] for f in ts.COMPACT_FIELDS], axis=1)
    count, rows = _compact_plain(emit, fields, dq_t, dq_n, max_emit)
    assert int(got.count) == count
    assert got.rows.dtype == torch.int32
    assert got.rows.numpy().tobytes() == rows.tobytes()
    assert int(got.err) == 0
