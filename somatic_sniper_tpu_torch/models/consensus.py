"""Consensus calling and somatic scoring in exact int32 torch ops.

Port of somatic_sniper_tpu/models/consensus.py:41-211 (itself the
replication of reference sniper_maqcns.c:250-273 and
somatic_sniper.c:79-273).  Every value is an int32 and every step is the
same integer operation as in the JAX module, so the results are
bit-identical; the one-hot matmuls and unrolled selects the TPU needed
for small-table lookups become plain indexing.  The reference's
tie-breaking scan orders and the stale-``i`` quirk of the joint-mode
consensus-quality loop are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import GLF_BASE

I32 = torch.int32

# homozygous slots (AA, CC, GG, TT) get no het penalty in glf2cns
_QR_MASK = (0, 1, 1, 1, 0, 1, 1, 0, 1, 0)


class ConsensusCall(NamedTuple):
    """Unpacked fields of the reference's packed consensus word."""

    base1: torch.Tensor   # [B] best genotype, 4-bit allele set
    base2: torch.Tensor   # [B] second-best genotype
    score1: torch.Tensor  # [B] consensus quality (min2 - min)
    score2: torch.Tensor  # [B] second consensus quality (min3 - min2)


class SomaticScore(NamedTuple):
    q_posterior_sum: torch.Tensor          # [B] somatic score
    joint_tumor_gt: torch.Tensor           # [B] 4-bit set, 0 unless joint
    joint_normal_gt: torch.Tensor          # [B]
    joint_consensus_quality: torch.Tensor  # [B]


def _glf_base(device) -> torch.Tensor:
    return torch.as_tensor(GLF_BASE, dtype=I32, device=device)


def glf2cns_batch(lk, n_total, q_r_int: int) -> ConsensusCall:
    """Batched sniper_glf2cns + the n == 0 guard of sniper_maqcns_call.

    ``lk`` [B, 10] int32, ``n_total`` [B] raw column depth.  The
    reference's strict-< scan over the ten genotypes is three argmins
    (first minimum wins), each masking the previous winner."""
    qr = torch.tensor(_QR_MASK, dtype=I32, device=lk.device)
    t = lk + qr * q_r_int
    big = 1 << 20
    i1 = torch.argmin(t, dim=1, keepdim=True)
    m1 = t.gather(1, i1)
    t2 = t.scatter_add(1, i1, torch.full_like(m1, big))
    i2 = torch.argmin(t2, dim=1, keepdim=True)
    m2 = t2.gather(1, i2)
    m3 = t2.scatter_add(1, i2, torch.full_like(m2, big)).amin(dim=1)
    m1, m2 = m1[:, 0], m2[:, 0]

    base = _glf_base(lk.device)
    nz = n_total > 0
    zero = torch.zeros_like(m1)
    return ConsensusCall(
        base1=torch.where(nz, base[i1[:, 0]], 0xF),
        base2=torch.where(nz, base[i2[:, 0]], 0xF),
        score1=torch.where(nz, (m2 - m1).clamp(max=255), zero),
        score2=torch.where(nz, (m3 - m2).clamp(max=255), zero),
    )


def make_qadd():
    """The closed-form qAdd (reference somatic_sniper.c:13-18).

    qAdd(x, y) = x + qAddTable[512 + y - x] equals, with
    d = clip(y - x, -512, 511),
    ``x + min(d, 0) - (|d|<2) - (|d|<4) - (|d|<10)``; the JAX module's
    docstring derives it and tests hold it to the generated table."""

    def qadd(x, y):
        d = (y - x).clamp(-512, 511)
        a = d.abs()
        corr = (a < 2).to(I32) + (a < 4).to(I32) + (a < 10).to(I32)
        return x + d.clamp(max=0) - corr

    return qadd


def posteriors_batch(lk, ref16, solo_prior, qadd):
    """Batched calculatePosteriors (reference somatic_sniper.c:79-99)."""
    x = lk + solo_prior[ref16.long()]
    qsum = torch.full_like(x[:, 0], 255)
    for j in range(10):
        qsum = qadd(x[:, j], qsum)  # qAdd(x, qSum): argument order kept
    return (x - qsum[:, None]).clamp(max=255)


def somatic_score_batch(lk_tumor, lk_normal, ref16, solo_prior,
                        joint_prior, qadd, use_joint: bool) -> SomaticScore:
    """The somatic-score core (reference somatic_sniper.c:166-214)."""
    B = lk_tumor.shape[0]
    dev = lk_tumor.device
    if use_joint:
        jp = joint_prior[ref16.long()]  # [B, 10, 10]
        joint_lk = (lk_normal[:, :, None] + lk_tumor[:, None, :]
                    + jp).clamp(max=255)  # i = normal, j = tumor
        flat = joint_lk.reshape(B, 100)
        best = torch.argmin(flat, dim=1)  # row-major scan, first wins
        ni = best // 10
        tj = best % 10

        marginal = torch.full((B,), 255, dtype=I32, device=dev)
        for t in range(100):
            marginal = qadd(marginal, flat[:, t])

        qps = torch.full((B,), 255, dtype=I32, device=dev)
        jcq = torch.full((B,), 255, dtype=I32, device=dev)
        for j in range(10):
            lkv = joint_lk[:, j, j] - marginal
            qps = qadd(qps, lkv)
            # stale-i quirk: the guard is effectively j != tumor argmin
            jcq = torch.where(tj != j, qadd(jcq, lkv), jcq)
        base = _glf_base(dev)
        return SomaticScore(
            q_posterior_sum=qps,
            joint_tumor_gt=base[tj],
            joint_normal_gt=base[ni],
            joint_consensus_quality=jcq.clamp(max=255),
        )
    lk_t_post = posteriors_batch(lk_tumor, ref16, solo_prior, qadd)
    lk_n_post = posteriors_batch(lk_normal, ref16, solo_prior, qadd)
    qps = torch.full((B,), 255, dtype=I32, device=dev)
    for j in range(10):
        qps = qadd(qps, lk_t_post[:, j] + lk_n_post[:, j])
    zero = torch.zeros((B,), dtype=I32, device=dev)
    return SomaticScore(
        q_posterior_sum=qps,
        joint_tumor_gt=zero,
        joint_normal_gt=zero,
        joint_consensus_quality=torch.full((B,), 255, dtype=I32,
                                           device=dev),
    )
