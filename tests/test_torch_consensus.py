"""Torch port of models/consensus.py against the JAX package: every
field is int32 arithmetic, so the results must be bit-identical."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from somatic_sniper_tpu.models import consensus as jc  # noqa: E402
from somatic_sniper_tpu.models import tables as T  # noqa: E402
from somatic_sniper_tpu_torch.models import consensus as tc  # noqa: E402


def _random_lk(B, seed, hi=256):
    """lk rows with many ties (small value range) and some n == 0."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, hi, (B, 10)).astype(np.int32)
    n = rng.integers(0, 4, B).astype(np.int32)
    ref16 = rng.choice([1, 2, 4, 8, 15, 3, 0], size=B).astype(np.int32)
    return lk, n, ref16


def _eq(a_jax, b_torch):
    np.testing.assert_array_equal(np.asarray(a_jax), b_torch.numpy())


@pytest.mark.parametrize("hi,seed", [(256, 0), (4, 1), (40, 2)])
def test_glf2cns_matches_jax(hi, seed):
    lk, n, _ = _random_lk(512, seed, hi)
    q_r_int = T.build_tables(T.ModelParams()).q_r_int
    want = jc.glf2cns_batch(jnp.asarray(lk), jnp.asarray(n), q_r_int)
    got = tc.glf2cns_batch(torch.from_numpy(lk), torch.from_numpy(n),
                           q_r_int)
    for a, b in zip(want, got):
        _eq(a, b)


def test_qadd_matches_table():
    """The closed-form qAdd equals qAddTable[512 + y - x] over the whole
    table range."""
    table = T.compute_qadd_table()
    x = np.repeat(np.arange(-300, 300, 7, dtype=np.int32), 1024)
    d = np.tile(np.arange(-512, 512, dtype=np.int32), len(x) // 1024)
    y = x + d
    got = tc.make_qadd()(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), x + table[512 + d])


@pytest.mark.parametrize("seed", [3, 4])
def test_posteriors_matches_jax(seed):
    lk, _, ref16 = _random_lk(512, seed)
    tabs = T.build_tables(T.ModelParams())
    want = jc.posteriors_batch(jnp.asarray(lk), jnp.asarray(ref16),
                               tabs.solo_prior, jc.make_qadd())
    got = tc.posteriors_batch(torch.from_numpy(lk), torch.from_numpy(ref16),
                              torch.from_numpy(tabs.solo_prior),
                              tc.make_qadd())
    _eq(want, got)


@pytest.mark.parametrize("use_joint,hi,seed", [
    (False, 256, 5), (False, 30, 6), (True, 256, 7), (True, 30, 8),
])
def test_somatic_score_matches_jax(use_joint, hi, seed):
    lk_t, _, ref16 = _random_lk(384, seed, hi)
    lk_n, _, _ = _random_lk(384, seed + 100, hi)
    tabs = T.build_tables(T.ModelParams(use_joint_priors=use_joint,
                                        somatic_mutation_rate=0.001))
    want = jc.somatic_score_batch(
        jnp.asarray(lk_t), jnp.asarray(lk_n), jnp.asarray(ref16),
        tabs.solo_prior, tabs.joint_prior, jc.make_qadd(), use_joint)
    got = tc.somatic_score_batch(
        torch.from_numpy(lk_t), torch.from_numpy(lk_n),
        torch.from_numpy(ref16), torch.from_numpy(tabs.solo_prior),
        torch.from_numpy(tabs.joint_prior), tc.make_qadd(), use_joint)
    for a, b in zip(want, got):
        _eq(a, b)
