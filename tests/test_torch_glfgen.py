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
from tests.torch_port_util import f32_tables, random_raw32  # noqa: E402

from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu.models.glfgen import ColumnBatch as JCB  # noqa: E402
from somatic_sniper_tpu.models.glfgen import (_fast_accumulate,  # noqa: E402
                                              glfgen_batch, pack_info)
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
    assert gk.LAUNCHES == {"accumulate32": 0, "assembly10": 0}
