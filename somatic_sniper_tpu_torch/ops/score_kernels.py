"""The scoring step after glfgen as one kernel: its CUDA wrapper and its
plain torch version.

``score_columns`` computes, for both samples of every column, what
``models.somatic.call_batch`` computes after glfgen: the consensus
(``glf2cns_batch``), the somatic score (``somatic_score_batch``, both
modes), the emission gates, the two statuses and, over raw kept-only
lanes, the dqstats rows (``_device_dqstats``).  On the card that is one launch of
``csrc/score_columns.cu``, which replaces the XLA fusions of the JAX
package's jitted ``call_batch`` (somatic_sniper_tpu/models/consensus.py
:41-211, somatic.py:62-286); ``score_columns_plain`` is the same work in
torch ops, bit for bit.  The wrapper checks its inputs, then

* for tensors on the CPU, runs the plain version;
* for CUDA tensors, launches the kernel on the current stream and counts
  the launch in ``glfgen_kernels.LAUNCHES["score_columns"]`` — or raises.
  There is no fallback from the card to the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import GERMLINE, LOH, SOMATIC, UNKNOWN, WILDTYPE
from ..models.allele_util import (genotype_is_proper_subset,
                                  should_filter_as_gor, should_filter_as_loh)
from ..models.consensus import glf2cns_batch, make_qadd, somatic_score_batch
from ..models.fields import COMPACT_FIELDS
from .glfgen_kernels import LAUNCHES, _check, _launch, _ptr

I32 = torch.int32
F32 = torch.float32
N_DQ = 18  # the dqstats row (output.dqstats)
# glfgen_batch's depth: its count of non-deleted reads, clamped
MAX_GLF_DEPTH = 16777215


class ScoredColumns(NamedTuple):
    """What the scoring step keeps of a batch: ``emit`` [B] bool, the
    16 ``COMPACT_FIELDS`` as one [B, 16] int32 tensor in that order, and
    the [B, 18] int32 dqstats rows of each sample where the lanes carry
    them (else None)."""

    emit: torch.Tensor
    fields: torch.Tensor
    tumor_dq: torch.Tensor | None
    normal_dq: torch.Tensor | None


def _mean_499(s, o):
    """Exact integer ``(int)(sum/occ + 0.499)`` (reference dqstats.c):
    the f32 estimate is within +/-1 of the largest k with
    ``(1000k - 499) * occ <= 1000 * sum``, and one integer-predicate
    fixup each way makes it exact."""
    o1 = o.clamp(min=1)
    k0 = (s.to(F32) / o1.to(F32) + 0.499).to(I32)

    def ok(k):
        return (1000 * k - 499) * o1 <= 1000 * s

    k = torch.where(ok(k0 + 1), k0 + 1, torch.where(ok(k0), k0, k0 - 1))
    return torch.where(o > 0, k, 0)


def _device_dqstats(slots, n_keep, rb4, wanted):
    """[B, 18] int32 dqstats rows over raw kept-only lanes, bit-exact
    with output.dqstats (reference dqstats.c:6-53), quirks included:
    raw base codes (a '=' base is 0 and counts toward every base_occ)
    and mean fields zeroed for un-wanted bases."""
    B, D = slots.shape
    s = slots
    j_idx = torch.arange(D, device=s.device)[None, :]
    valid = j_idx < n_keep[:, None]
    mq = torch.where(valid, s & 0xFF, 0)
    bq = torch.where(valid, (s >> 8) & 0xFF, 0)
    b = (s >> 16) & 0xF
    st = (s >> 20) & 1

    def count(m):
        return m.sum(dim=1, dtype=I32)

    depth = n_keep
    tot_mq = mq.sum(dim=1, dtype=I32)
    is_ref = valid & (b == rb4[:, None])
    not_ref = valid & (b != rb4[:, None])
    dp4 = [count(is_ref & (st == 0)), count(is_ref & (st == 1)),
           count(not_ref & (st == 0)), count(not_ref & (st == 1))]
    occ, mean_bq, mean_mq = [], [], []
    for j in range(4):
        v = 1 << j
        m = valid & ((b & v) == b)
        o = count(m)
        w = ((wanted & v) != 0).to(I32)
        sb = torch.where(m, bq, 0).sum(dim=1, dtype=I32) * w
        sm = torch.where(m, mq, 0).sum(dim=1, dtype=I32) * w
        occ.append(o)
        mean_bq.append(_mean_499(sb, o))
        mean_mq.append(_mean_499(sm, o))
    tot_mean = _mean_499(tot_mq, depth)
    return torch.stack(mean_bq + mean_mq + occ + dp4 + [depth, tot_mean],
                       dim=1)


def score_columns_plain(lk_t, lk_n, depth_t, depth_n, n_t, n_n, ref16,
                        solo_prior, joint_prior, q_r_int: int, params,
                        dq_lanes=None) -> ScoredColumns:
    """The scoring step in torch ops (port of call_batch,
    somatic_sniper_tpu/models/somatic.py:176-250); inputs as
    ``score_columns``."""
    t_b1, t_b2, t_s1, t_s2 = glf2cns_batch(lk_t, depth_t, q_r_int)
    n_b1, n_b2, n_s1, n_s2 = glf2cns_batch(lk_n, depth_n, q_r_int)
    rb4 = ref16
    gd_t = n_t.clamp(max=MAX_GLF_DEPTH)
    gd_n = n_n.clamp(max=MAX_GLF_DEPTH)

    # outer gate (reference somatic_sniper.c:127) + SNP gate (:156)
    is_snp = ((gd_t > 0) & (gd_n > 0) & (rb4 != 15)
              & (t_b1 != 15) & (n_b1 != 15) & (t_b1 != n_b1))
    tumor_snp_q = torch.where(t_b2 == rb4, t_s1, t_s1 + t_s2).clamp(max=255)
    normal_snp_q = torch.where(
        (n_b1 != 15) & (n_b1 != rb4),
        torch.where(n_b2 == rb4, n_s1, n_s1 + n_s2).clamp(max=255),
        0,
    )

    score = somatic_score_batch(lk_t, lk_n, rb4, solo_prior, joint_prior,
                                make_qadd(), params.use_joint_priors)
    qps = score.q_posterior_sum

    # joint-aware effective genotypes (reference somatic_sniper.c:216-223)
    tumor_eff = torch.where(score.joint_tumor_gt != 0, score.joint_tumor_gt,
                            t_b1)
    normal_eff = torch.where(score.joint_normal_gt != 0,
                             score.joint_normal_gt, n_b1)

    loh = should_filter_as_loh(rb4, tumor_eff, normal_eff)
    gor = should_filter_as_gor(rb4, tumor_eff, normal_eff)
    emit = is_snp & (qps >= params.min_somatic_qual)
    if not params.include_loh:
        emit = emit & ~loh
    if not params.include_gor:
        emit = emit & ~gor

    # statuses (reference somatic_sniper.c:241-261)
    t_status = torch.where(
        tumor_eff == normal_eff, GERMLINE,
        torch.where(genotype_is_proper_subset(tumor_eff, normal_eff), LOH,
                    torch.where(qps > 0, SOMATIC, UNKNOWN)),
    ).to(I32)
    n_status = torch.where(n_b1 == rb4, WILDTYPE, GERMLINE).to(I32)

    named = dict(
        tumor_gt=t_b1, normal_gt=n_b1, tumor_cnsq=t_s1, normal_cnsq=n_s1,
        tumor_vaq=tumor_snp_q, normal_vaq=normal_snp_q, somatic_score=qps,
        joint_tumor_gt=score.joint_tumor_gt,
        joint_normal_gt=score.joint_normal_gt,
        joint_cnsq=score.joint_consensus_quality, tumor_status=t_status,
        normal_status=n_status, tumor_eff_gt=tumor_eff,
        normal_eff_gt=normal_eff, tumor_depth=gd_t, normal_depth=gd_n)
    fields = torch.stack([named[f] for f in COMPACT_FIELDS], dim=1)
    dq_t = dq_n = None
    if dq_lanes is not None:
        slots_t, nk_t, slots_n, nk_n = dq_lanes
        wanted = rb4 | tumor_eff | normal_eff
        dq_t = _device_dqstats(slots_t, nk_t, rb4, wanted)
        dq_n = _device_dqstats(slots_n, nk_n, rb4, wanted)
    return ScoredColumns(emit, fields, dq_t, dq_n)


def score_columns(lk_t, lk_n, depth_t, depth_n, n_t, n_n, ref16,
                  solo_prior, joint_prior, q_r_int: int, params,
                  dq_lanes=None) -> ScoredColumns:
    """Consensus, somatic score, gates, statuses and dqstats of B
    columns, both samples.

    ``lk_t``/``lk_n`` i32[B, 10] glfgen likelihoods; ``depth_t``/
    ``depth_n`` i32[B] the raw column depths (deletions counted: the
    consensus's n == 0 guard); ``n_t``/``n_n`` i32[B] glfgen's counts of
    non-deleted reads (the SNP gate and the depth fields); ``ref16``
    i32[B] in [0, 15]; ``solo_prior`` i32[16, 10] and ``joint_prior``
    i32[16, 10, 10] (``DeviceTables``); ``params`` a ModelParams
    (``use_joint_priors``, ``min_somatic_qual``, ``include_loh``,
    ``include_gor``).  ``dq_lanes`` is None, or ``(slots_t, nk_t,
    slots_n, nk_n)``: raw kept-only i32[B, D] lanes and their i32[B]
    counts, whose dqstats rows are then computed.  Returns
    ScoredColumns, equal bit for bit to ``score_columns_plain``."""
    if not isinstance(lk_t, torch.Tensor) or lk_t.dim() != 2:
        raise ValueError("lk_t: expected [B, 10]")
    B = lk_t.shape[0]
    dev = lk_t.device
    for name, t, shape in (
            ("lk_t", lk_t, (B, 10)), ("lk_n", lk_n, (B, 10)),
            ("depth_t", depth_t, (B,)), ("depth_n", depth_n, (B,)),
            ("n_t", n_t, (B,)), ("n_n", n_n, (B,)), ("ref16", ref16, (B,)),
            ("solo_prior", solo_prior, (16, 10)),
            ("joint_prior", joint_prior, (16, 10, 10))):
        _check(name, t, I32, shape, dev)
    if dq_lanes is not None:
        if len(dq_lanes) != 4 or not isinstance(dq_lanes[0], torch.Tensor) \
                or dq_lanes[0].dim() != 2:
            raise ValueError("dq_lanes: expected (slots_t [B, D], nk_t, "
                             "slots_n [B, D], nk_n)")
        D = dq_lanes[0].shape[1]
        if D < 1:
            raise ValueError("dq_lanes: depth D must be at least 1")
        for name, t, shape in zip(("slots_t", "nk_t", "slots_n", "nk_n"),
                                  dq_lanes, ((B, D), (B,), (B, D), (B,))):
            _check(name, t, I32, shape, dev)
    if dev.type == "cpu":
        return score_columns_plain(lk_t, lk_n, depth_t, depth_n, n_t, n_n,
                                   ref16, solo_prior, joint_prior, q_r_int,
                                   params, dq_lanes)
    if dev.type != "cuda":
        raise ValueError(f"score_columns: unsupported device {dev}")
    emit = torch.empty((B,), dtype=torch.bool, device=dev)
    fields = torch.empty((B, len(COMPACT_FIELDS)), dtype=I32, device=dev)
    dq_t = dq_n = None
    if dq_lanes is not None:
        dq_t = torch.empty((B, N_DQ), dtype=I32, device=dev)
        dq_n = torch.empty((B, N_DQ), dtype=I32, device=dev)
    out = ScoredColumns(emit, fields, dq_t, dq_n)
    if B == 0:
        return out
    slots_t, nk_t, slots_n, nk_n = dq_lanes or (None,) * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_score_columns", *(
            0 if t is None else _ptr(t) for t in (
                lk_t, lk_n, depth_t, depth_n, n_t, n_n, ref16, solo_prior,
                joint_prior, slots_t, slots_n, nk_t, nk_n, emit, fields,
                dq_t, dq_n)),
            B, 0 if slots_t is None else slots_t.shape[1], int(q_r_int),
            int(bool(params.use_joint_priors)), int(params.min_somatic_qual),
            int(bool(params.include_loh)), int(bool(params.include_gor)),
            stream)
    LAUNCHES["score_columns"] += 1
    return out
