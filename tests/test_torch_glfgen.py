"""Torch port of the glfgen kernels against the JAX package.

The port's plain versions (what the wrappers run for CPU tensors) are
held to the Pallas kernels in interpret mode and to the XLA fast path.
Tolerances: c and rms are integer counts and must be equal; esum/fsum
are f32 sums whose order differs between the implementations, hence
rtol 1e-6, atol 1e-5; the assembly on identical inputs must be
bit-identical; through the full glfgen the f32 sum-order noise may move
an lk by one quantization step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (f32_tables, hazard_column,  # noqa: E402
                                   random_raw32, random_u32, to_packed16)

from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.models.glfgen import ColumnBatch as JCB  # noqa: E402
from somatic_sniper_tpu.models.glfgen import (  # noqa: E402
    _fast_accumulate, _fast_accumulate16, glfgen_batch, pack_info)
from somatic_sniper_tpu.ops import pallas_glfgen as pg  # noqa: E402
from somatic_sniper_tpu_torch.models import glfgen as tg  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import (  # noqa: E402
    device_tables, fk_weights_f32)
from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk  # noqa: E402

CPU = torch.device("cpu")


@jax.jit
def _xla_acc(slots, nk, ref16):
    """The JAX fast path's raw-lane accumulate (glfgen.py:480-485)."""
    view = JCB(slots=slots, depth=nk, ref16=ref16)
    info, _n = pack_info(view)
    return _fast_accumulate(info, nk, 0.85, 0.03, 60)


def _port_acc(slots, nk, ref16):
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    return gk.accumulate32(
        torch.from_numpy(slots.view(np.int32)), torch.from_numpy(nk),
        torch.from_numpy(ref16), w, 60)


def _assert_acc(got, want):
    e, f, c, r = (t.numpy() for t in got)
    e_w, f_w, c_w, r_w = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(c, c_w)
    np.testing.assert_array_equal(r, r_w)
    np.testing.assert_allclose(e, e_w, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(f, f_w, rtol=1e-6, atol=1e-5)


SHAPES = [(64, 16, 0), (128, 48, 1), (96, 64, 2), (32, 128, 3)]


@pytest.mark.parametrize("B,D,seed", SHAPES)
def test_accumulate32_plain_matches_pallas(B, D, seed):
    slots, nk, _, ref16 = random_raw32(B, D, seed)
    want = pg.accumulate32(jnp.asarray(slots), jnp.asarray(nk),
                           jnp.asarray(ref16), theta=0.85, eta=0.03,
                           cap_mapq=60, interpret=True)
    _assert_acc(_port_acc(slots, nk, ref16), want)


@pytest.mark.parametrize("B,D,seed", SHAPES)
def test_accumulate32_plain_matches_xla(B, D, seed):
    slots, nk, _, ref16 = random_raw32(B, D, seed + 10)
    want = _xla_acc(jnp.asarray(slots), jnp.asarray(nk), jnp.asarray(ref16))
    _assert_acc(_port_acc(slots, nk, ref16), want)


def test_accumulate32_plain_full_depth_255():
    """Every lane occupied at D = 255 (the packed-metadata bound): the
    plain version still agrees with the XLA path on deep columns."""
    slots, nk, _, ref16 = random_raw32(16, 255, 21, p_del=0.0)
    nk[:] = 255
    want = _xla_acc(jnp.asarray(slots), jnp.asarray(nk), jnp.asarray(ref16))
    _assert_acc(_port_acc(slots, nk, ref16), want)


@pytest.mark.parametrize("B,D,seed", [(128, 16, 4), (256, 48, 5),
                                      (64, 64, 6)])
def test_assembly10_plain_matches_pallas(B, D, seed):
    """Identical accumulate outputs in, bit-identical lk/min_lk out."""
    slots, nk, _, ref16 = random_raw32(B, D, seed)
    e, f, c, _ = (t.numpy() for t in _port_acc(slots, nk, ref16))
    tabs = T.build_tables(T.ModelParams())
    nk1 = D + 1
    coef_sub = np.ascontiguousarray(
        tabs.coef[4:64, :nk1, :nk1].astype(np.float32))
    lhet_sub = np.ascontiguousarray(tabs.lhet[:nk1, :nk1].astype(np.float32))
    lk_w, mlk_w = pg.assembly10(jnp.asarray(e), jnp.asarray(f),
                                jnp.asarray(c), jnp.asarray(nk),
                                jnp.asarray(coef_sub), jnp.asarray(lhet_sub),
                                interpret=True)
    lk, mlk = gk.assembly10(*(torch.from_numpy(x) for x in
                              (e, f, c, nk, coef_sub, lhet_sub)))
    np.testing.assert_array_equal(lk.numpy(), np.asarray(lk_w))
    np.testing.assert_array_equal(mlk.numpy(), np.asarray(mlk_w))


def test_glfgen_matches_xla_fast_d128():
    """The port's glfgen (plain accumulate + assembly on the CPU) against
    glfgen_batch(precision="fast", backend="xla") at a deep slab."""
    B, D = 256, 128
    slots, nk, _, ref16 = random_raw32(B, D, 7)
    tabs = T.build_tables(T.ModelParams())
    fk, coef, lhet = f32_tables(tabs)
    want = glfgen_batch(
        JCB(slots=jnp.asarray(slots), depth=jnp.asarray(nk),
            ref16=jnp.asarray(ref16), n_keep=jnp.asarray(nk)),
        fk, coef, lhet, precision="fast", backend="xla")
    dtabs = device_tables(tabs, CPU)
    got = tg.glfgen_batch(
        tg.ColumnBatch(slots=torch.from_numpy(slots.view(np.int32)),
                       depth=torch.from_numpy(nk),
                       ref16=torch.from_numpy(ref16),
                       n_keep=torch.from_numpy(nk)),
        dtabs, 60)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.rms_mapq.numpy(),
                                  np.asarray(want.rms_mapq))
    assert np.abs(got.min_lk.numpy().astype(int)
                  - np.asarray(want.min_lk).astype(int)).max() <= 1
    diff = np.abs(got.lk.numpy().astype(int)
                  - np.asarray(want.lk).astype(int))
    assert diff.max() <= 1
    assert (diff == 0).all(axis=1).mean() >= 0.99


def test_wrappers_check_inputs():
    slots, nk, _, ref16 = random_raw32(8, 16, 8)
    s = torch.from_numpy(slots.view(np.int32))
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    with pytest.raises(TypeError):
        gk.accumulate32(s.to(torch.int64), torch.from_numpy(nk),
                        torch.from_numpy(ref16), w, 60)
    with pytest.raises(ValueError):
        gk.accumulate32(s[:, ::2], torch.from_numpy(nk),
                        torch.from_numpy(ref16), w, 60)
    with pytest.raises(ValueError):
        gk.accumulate32(torch.zeros((8, 256), dtype=torch.int32),
                        torch.from_numpy(nk), torch.from_numpy(ref16), w, 60)
    e = torch.zeros((8, 4))
    c = torch.zeros((8, 4), dtype=torch.int32)
    n = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):  # c_tot would need the rescale
        gk.assembly10(e, e, c, n, torch.zeros((60, 257, 257)),
                      torch.zeros((257, 257)))
    with pytest.raises(ValueError):  # class counts deeper than the table
        gk.assembly10(e, e, c + 5, n, torch.zeros((60, 17, 17)),
                      torch.zeros((17, 17)))
    with pytest.raises(ValueError):  # a negative class count
        gk.assembly10(e, e, c - 1, n, torch.zeros((60, 17, 17)),
                      torch.zeros((17, 17)))
    assert gk.LAUNCHES == {"accumulate32": 0, "accumulate": 0,
                           "accumulate16": 0, "assembly10": 0}


# -- accumulate (full u32 slots, deletions among the lanes) ---------------

@jax.jit
def _xla_acc_u32(slots, depth, ref16):
    """The JAX fast path's full-u32 accumulate (glfgen.py:520-524)."""
    info, n = pack_info(JCB(slots=slots, depth=depth, ref16=ref16))
    return (*_fast_accumulate(info, n, 0.85, 0.03, 60), n)


def _port_acc_u32(slots, depth, ref16):
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    return gk.accumulate(
        torch.from_numpy(slots.view(np.int32)), torch.from_numpy(depth),
        torch.from_numpy(ref16), w, 60)


def _assert_acc_u32(got, want, rtol=1e-6):
    e, f, c, r, n = (t.numpy() for t in got)
    e_w, f_w, c_w, r_w, n_w = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(c, c_w)
    np.testing.assert_array_equal(r, r_w)
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_allclose(e, e_w, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(f, f_w, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B,D,seed", [(64, 16, 0), (128, 32, 1),
                                      (96, 64, 2), (48, 31, 12),
                                      (48, 33, 13), (32, 65, 14),
                                      (16, 129, 15)])
def test_accumulate_plain_matches_pallas_and_xla(B, D, seed):
    slots, depth, ref16 = random_u32(B, D, seed)
    got = _port_acc_u32(slots, depth, ref16)
    want_p = pg.accumulate(jnp.asarray(slots), jnp.asarray(depth),
                           jnp.asarray(ref16), theta=0.85, eta=0.03,
                           cap_mapq=60, interpret=True)
    _assert_acc_u32(got, want_p)
    _assert_acc_u32(got, _xla_acc_u32(jnp.asarray(slots),
                                      jnp.asarray(depth),
                                      jnp.asarray(ref16)))


@pytest.mark.parametrize("B,D,seed", [(16, 300, 3), (4, 1100, 4)])
def test_accumulate_plain_matches_xla_deep(B, D, seed):
    """Past the Pallas kernel's reach (its rank loop is O(D^2)): held to
    the XLA path alone; sums of hundreds of terms in another order."""
    slots, depth, ref16 = random_u32(B, D, seed)
    want = _xla_acc_u32(jnp.asarray(slots), jnp.asarray(depth),
                        jnp.asarray(ref16))
    _assert_acc_u32(_port_acc_u32(slots, depth, ref16), want, rtol=1e-4)


def test_accumulate_plain_ranks_by_raw_eff():
    """The hazard column: the reference and the XLA path rank by the raw
    min(baseQ, mapQ); the port follows them."""
    slots, depth, ref16 = hazard_column()
    got = _port_acc_u32(slots, depth, ref16)
    want = _xla_acc_u32(jnp.asarray(slots), jnp.asarray(depth),
                        jnp.asarray(ref16))
    _assert_acc_u32(got, want)
    np.testing.assert_allclose(got[0].numpy()[0, 0], 35.4868, rtol=1e-6)
    # The Pallas kernel ranks by the FLOORED eff (pallas_glfgen.py:80-87):
    # the (1, 0) read's eff is floored to 4 and outranks the (64, 3)
    # read's 3, which moves esum[A] to 35.610474; c, n and fsum agree.
    # The port must not take that slip on.
    e_p = np.asarray(pg.accumulate(
        jnp.asarray(slots), jnp.asarray(depth), jnp.asarray(ref16),
        theta=0.85, eta=0.03, cap_mapq=60, interpret=True)[0])
    assert abs(float(e_p[0, 0]) - float(got[0].numpy()[0, 0])) > 0.1


# -- accumulate16 (compact u16 lanes) --------------------------------------

def _port_acc16(slots16, nk):
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    return gk.accumulate16(torch.from_numpy(slots16), torch.from_numpy(nk),
                           w)


def _assert_acc16(got, want, rtol=1e-6):
    e, f, c = (t.numpy() for t in got)
    e_w, f_w, c_w = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(c, c_w)
    np.testing.assert_allclose(e, e_w, rtol=rtol, atol=1e-5)
    np.testing.assert_allclose(f, f_w, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("B,D,seed", [(64, 16, 5), (128, 24, 6),
                                      (96, 64, 7), (64, 128, 8),
                                      (48, 31, 16), (48, 33, 17),
                                      (32, 65, 18), (16, 129, 19)])
def test_accumulate16_plain_matches_pallas_and_xla(B, D, seed):
    s16, nk, _ = to_packed16(*random_u32(B, D, seed))
    got = _port_acc16(s16, nk)
    if D <= 128:  # the Pallas kernel cannot pad past 128 lanes
        _assert_acc16(got, pg.accumulate16(jnp.asarray(s16), jnp.asarray(nk),
                                           theta=0.85, eta=0.03,
                                           interpret=True))
    _assert_acc16(got, _fast_accumulate16(jnp.asarray(s16),
                                          jnp.asarray(nk), 0.85, 0.03))


def test_accumulate16_plain_matches_xla_deep():
    s16, nk, _ = to_packed16(*random_u32(16, 512, 9))
    want = _fast_accumulate16(jnp.asarray(s16), jnp.asarray(nk), 0.85, 0.03)
    _assert_acc16(_port_acc16(s16, nk), want, rtol=1e-4)


# -- glfgen over the batch path's encodings --------------------------------

def _assert_glf(got, want):
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(want.depth))
    np.testing.assert_array_equal(got.rms_mapq.numpy(),
                                  np.asarray(want.rms_mapq))
    for a, b in ((got.lk, want.lk), (got.min_lk, want.min_lk)):
        d = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
        assert d.max() <= 1
        assert (d.reshape(len(d), -1) == 0).all(axis=1).mean() >= 0.99


@pytest.mark.parametrize("encoding", ["u16", "u32"])
@pytest.mark.parametrize("B,D,seed", [(256, 24, 10), (64, 300, 11)])
def test_glfgen_batch_encodings_match_xla(encoding, B, D, seed):
    """The port's glfgen over u16 and full-u32 batches against
    glfgen_batch(precision="fast", backend="xla"); D = 300 holds columns
    with more than 255 counted reads, which take the c_tot > 255
    rescale before the assembly."""
    slots, depth, ref16 = random_u32(B, D, seed)
    tabs = T.build_tables(T.ModelParams())
    fk, coef, lhet = f32_tables(tabs)
    if encoding == "u16":
        s16, nk, rms = to_packed16(slots, depth, ref16)
        jcb = JCB(slots=jnp.asarray(s16), depth=jnp.asarray(depth),
                  ref16=jnp.asarray(ref16), n_keep=jnp.asarray(nk),
                  rms_sum=jnp.asarray(rms))
        tcb = tg.ColumnBatch(
            slots=torch.from_numpy(s16), depth=torch.from_numpy(depth),
            ref16=torch.from_numpy(ref16), n_keep=torch.from_numpy(nk),
            rms_sum=torch.from_numpy(rms))
    else:
        jcb = JCB(slots=jnp.asarray(slots), depth=jnp.asarray(depth),
                  ref16=jnp.asarray(ref16))
        tcb = tg.ColumnBatch(slots=torch.from_numpy(slots.view(np.int32)),
                             depth=torch.from_numpy(depth),
                             ref16=torch.from_numpy(ref16))
    if D > 255:
        _, _, c, _, _ = _port_acc_u32(slots, depth, ref16)
        assert (c.sum(dim=1) > 255).sum() >= 5, "no column takes the rescale"
    want = glfgen_batch(jcb, fk, coef, lhet, precision="fast", backend="xla")
    got = tg.glfgen_batch(tcb, device_tables(tabs, CPU), 60)
    _assert_glf(got, want)


def test_glfgen_rescale_total_256_matches_xla():
    """Four classes of 127 counted reads: the rescale rounds each 63.5 up
    to 64, c_tot = 256, one past the table; the JAX package's gather
    clamps to row 255 and the port reads the same row."""
    D = 508
    rng = np.random.default_rng(12)
    base = np.repeat(np.array([1, 2, 4, 8], np.uint32), 127)[None, :]
    baseq = rng.integers(10, 40, (1, D)).astype(np.uint32)
    mapq = rng.integers(20, 60, (1, D)).astype(np.uint32)
    strand = rng.integers(0, 2, (1, D)).astype(np.uint32)
    slots = mapq | (baseq << 8) | (base << 16) | (strand << 20)
    depth = np.array([D], np.int32)
    ref16 = np.array([1], np.int32)
    tabs = T.build_tables(T.ModelParams())
    fk, coef, lhet = f32_tables(tabs)
    c = _port_acc_u32(slots, depth, ref16)[2]
    assert tg.rescale_counts(c).sum().item() == 256
    want = glfgen_batch(JCB(slots=jnp.asarray(slots), depth=jnp.asarray(depth),
                            ref16=jnp.asarray(ref16)),
                        fk, coef, lhet, precision="fast", backend="xla")
    got = tg.glfgen_batch(
        tg.ColumnBatch(slots=torch.from_numpy(slots.view(np.int32)),
                       depth=torch.from_numpy(depth),
                       ref16=torch.from_numpy(ref16)),
        device_tables(tabs, CPU), 60)
    _assert_glf(got, want)


def test_rank_wrappers_check_inputs():
    w = torch.from_numpy(fk_weights_f32(0.85, 0.03))
    nk = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):  # u16 lanes must arrive as uint16
        gk.accumulate16(torch.zeros((4, 8), dtype=torch.int32), nk, w)
    with pytest.raises(TypeError):  # full slots cross as int32
        gk.accumulate(torch.zeros((4, 8), dtype=torch.int64), nk, nk, w, 60)
    with pytest.raises(ValueError):
        gk.accumulate(torch.zeros((4, 0), dtype=torch.int32), nk, nk, w, 60)
    with pytest.raises(ValueError):
        gk.accumulate16(torch.zeros((4, 8), dtype=torch.uint16), nk[:3], w)
    assert tg.ColumnBatch(torch.zeros((4, 8), dtype=torch.int32), nk,
                          nk).encoding == "u32"
    with pytest.raises(ValueError):  # u16 lanes need the host's rms
        tg.ColumnBatch(torch.zeros((4, 8), dtype=torch.uint16), nk, nk,
                       n_keep=nk).encoding
    assert set(gk.LAUNCHES.values()) == {0}
