"""Torch port of models/somatic.py against the JAX package.

dqstats are integer arithmetic and must be bit-identical.  The i32 rows
of call_batch_packed go through f32 class sums whose summation order
differs between the implementations, so the fast contract applies:
index, calls, statuses, depths and dqstats equal; score, consensus and
variant-allele qualities within +/-1, and at least 99% of rows
identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from tests.torch_port_util import (f32_tables, random_raw32,  # noqa: E402
                                   random_slab)

from somatic_sniper_tpu.models import somatic as js  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models import somatic as ts  # noqa: E402
from somatic_sniper_tpu_torch.models.tables import device_tables  # noqa: E402

CPU = torch.device("cpu")
# columns of the rows allowed to differ by one quantization step:
# tumor/normal cnsq, tumor/normal vaq, somatic score, joint cnsq
PM1_COLS = [1 + js.COMPACT_FIELDS.index(f) for f in (
    "tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
    "somatic_score", "joint_cnsq")]


def test_compact_fields_match_jax():
    assert ts.COMPACT_FIELDS == js.COMPACT_FIELDS


def test_mean_499_matches_jax():
    occ = np.arange(0, 256, dtype=np.int32)
    sums = np.arange(0, 256 * 255, 61, dtype=np.int32)
    O, S = (a.ravel() for a in np.meshgrid(occ, sums))
    keep = S <= np.maximum(O, 1) * 255
    O, S = O[keep], S[keep]
    want = js._mean_499(jnp.asarray(S), jnp.asarray(O))
    got = ts._mean_499(torch.from_numpy(S), torch.from_numpy(O))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("B,D,seed", [(128, 48, 1), (64, 255, 2)])
def test_device_dqstats_matches_jax(B, D, seed):
    slots, nk, _, rb4 = random_raw32(B, D, seed)
    wanted = (rb4 | np.random.default_rng(seed).integers(0, 16, B)).astype(
        np.int32)
    want = js._device_dqstats(jnp.asarray(slots), jnp.asarray(nk),
                              jnp.asarray(rb4), jnp.asarray(wanted))
    got = ts._device_dqstats(torch.from_numpy(slots.view(np.int32)),
                             torch.from_numpy(nk), torch.from_numpy(rb4),
                             torch.from_numpy(wanted))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("D", [16, 48])
@pytest.mark.parametrize("use_joint", [False, True])
def test_call_batch_packed_rows_match_jax(D, use_joint):
    B = 256
    stacked, meta = random_slab(B, D, seed=D + 7 * use_joint)
    params = T.ModelParams(use_joint_priors=use_joint,
                           somatic_mutation_rate=0.001, min_somatic_qual=0)
    tabs = T.build_tables(params)
    fk, coef, lhet = f32_tables(tabs)
    want = js.call_batch_packed(
        jnp.asarray(stacked), jnp.asarray(meta), fk, coef, lhet,
        tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
        use_joint=use_joint, min_somatic_qual=params.min_somatic_qual,
        include_loh=params.include_loh, include_gor=params.include_gor,
        cap_mapq=params.cap_mapq, theta=params.theta, eta=params.eta,
        max_emit=B, glf_backend="xla", row_dtype="i32")
    got = ts.call_batch_packed(
        torch.from_numpy(stacked.view(np.int32)), torch.from_numpy(meta),
        device_tables(tabs, CPU), params)

    count = int(got.count)
    assert count == int(want.count)
    assert count > B // 8, "too few emitted rows to compare"
    rows = got.rows.numpy()[:count].astype(int)
    rows_w = np.asarray(want.rows)[:count].astype(int)
    assert rows.shape == rows_w.shape == (count, 1 + 16 + 36)
    exact_cols = [j for j in range(rows.shape[1]) if j not in PM1_COLS]
    np.testing.assert_array_equal(rows[:, exact_cols], rows_w[:, exact_cols])
    assert np.abs(rows - rows_w).max() <= 1
    assert (rows == rows_w).all(axis=1).mean() >= 0.99


def test_call_batch_packed_checks_bounds():
    dtabs = device_tables(T.build_tables(T.ModelParams()), CPU)
    meta = torch.zeros((3, 4), dtype=torch.int32)
    # past the wide metadata's 16-bit depths (256 and deeper to 65535
    # take the wide layout, tests/test_torch_deep_slab.py)
    with pytest.raises(ValueError):
        ts.call_batch_packed(
            torch.zeros((2, 4, ts.MAX_D + 1), dtype=torch.int32), meta,
            dtabs, T.ModelParams())
    with pytest.raises(ValueError):
        ts.call_batch_packed(torch.zeros((4, 16), dtype=torch.int32),
                             meta, dtabs, T.ModelParams())
