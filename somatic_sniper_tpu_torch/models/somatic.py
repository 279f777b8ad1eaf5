"""Batched somatic calling in torch, fast precision.

Port of somatic_sniper_tpu/models/somatic.py (:62-124, :137-274,
:279-385, :395-538): glfgen of both samples, consensus, the somatic
score and the emission gates, the on-device dqstats (raw kept-only
lanes only), and compaction of the emitted sites into i32 rows for the
slab path (``call_batch_packed``) and the batch path
(``call_batch_stacked``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import GERMLINE, LOH, SOMATIC, UNKNOWN, WILDTYPE
from .allele_util import (
    genotype_is_proper_subset,
    should_filter_as_gor,
    should_filter_as_loh,
)
from .consensus import glf2cns_batch, make_qadd, somatic_score_batch
from .glfgen import ColumnBatch, glfgen_batch
from .tables import DeviceTables, ModelParams

I32 = torch.int32
F32 = torch.float32

# the packed slab metadata carries depths and counts in bytes
MAX_D = 255

# host-side field order of the compacted rows (the JAX package's order,
# somatic_sniper_tpu/models/somatic.py:279-285); the leading columns
# are the batch index of each emitted site
COMPACT_FIELDS = (
    "tumor_gt", "normal_gt", "tumor_cnsq", "normal_cnsq",
    "tumor_vaq", "normal_vaq", "somatic_score",
    "joint_tumor_gt", "joint_normal_gt", "joint_cnsq",
    "tumor_status", "normal_status", "tumor_eff_gt", "normal_eff_gt",
    "tumor_depth", "normal_depth",
)


class CallResult(NamedTuple):
    """Per-column call record (device output; the host formats text)."""

    emit: torch.Tensor
    tumor_gt: torch.Tensor
    normal_gt: torch.Tensor
    tumor_cnsq: torch.Tensor
    normal_cnsq: torch.Tensor
    tumor_vaq: torch.Tensor
    normal_vaq: torch.Tensor
    somatic_score: torch.Tensor
    joint_tumor_gt: torch.Tensor
    joint_normal_gt: torch.Tensor
    joint_cnsq: torch.Tensor
    tumor_status: torch.Tensor
    normal_status: torch.Tensor
    tumor_eff_gt: torch.Tensor
    normal_eff_gt: torch.Tensor
    tumor_depth: torch.Tensor
    normal_depth: torch.Tensor
    # [B, 18] int32 dqstats rows; only raw kept-only lanes carry them
    tumor_dq: torch.Tensor | None = None
    normal_dq: torch.Tensor | None = None


class CompactResult(NamedTuple):
    """Emitted rows first, in ascending batch index; rows past ``count``
    repeat column 0.  ``rows`` is [K, 1 + 16 (+ 36)] int32: the batch
    index, the COMPACT_FIELDS, then tumor and normal dqstats when the
    lanes carry them, with K = min(max_emit, B).  ``count`` may exceed
    K, and the caller then refetches the full CallResult.  The JAX
    package's byte-narrow u8 rows hid a slow device-to-host link, which
    a card on the host's PCIe does not have."""

    count: torch.Tensor  # [] int32
    rows: torch.Tensor


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


def call_batch(tumor: ColumnBatch, normal: ColumnBatch, dtabs: DeviceTables,
               params: ModelParams) -> CallResult:
    """Batched glf_somatic (reference somatic_sniper.c:109-273), fast
    precision, with the dqstats rows of both samples when the lanes are
    raw kept-only words (the other encodings cannot give them,
    somatic.py:239-252)."""
    p = params
    g_t = glfgen_batch(tumor, dtabs, p.cap_mapq)
    g_n = glfgen_batch(normal, dtabs, p.cap_mapq)
    t_b1, t_b2, t_s1, t_s2 = glf2cns_batch(g_t.lk, tumor.depth,
                                           dtabs.q_r_int)
    n_b1, n_b2, n_s1, n_s2 = glf2cns_batch(g_n.lk, normal.depth,
                                           dtabs.q_r_int)
    rb4 = tumor.ref16

    # outer gate (reference somatic_sniper.c:127) + SNP gate (:156)
    is_snp = ((g_t.depth > 0) & (g_n.depth > 0) & (rb4 != 15)
              & (t_b1 != 15) & (n_b1 != 15) & (t_b1 != n_b1))
    tumor_snp_q = torch.where(t_b2 == rb4, t_s1, t_s1 + t_s2).clamp(max=255)
    normal_snp_q = torch.where(
        (n_b1 != 15) & (n_b1 != rb4),
        torch.where(n_b2 == rb4, n_s1, n_s1 + n_s2).clamp(max=255),
        0,
    )

    score = somatic_score_batch(
        g_t.lk, g_n.lk, rb4, dtabs.solo_prior, dtabs.joint_prior,
        make_qadd(), p.use_joint_priors)
    qps = score.q_posterior_sum

    # joint-aware effective genotypes (reference somatic_sniper.c:216-223)
    tumor_eff = torch.where(score.joint_tumor_gt != 0, score.joint_tumor_gt,
                            t_b1)
    normal_eff = torch.where(score.joint_normal_gt != 0,
                             score.joint_normal_gt, n_b1)

    loh = should_filter_as_loh(rb4, tumor_eff, normal_eff)
    gor = should_filter_as_gor(rb4, tumor_eff, normal_eff)
    emit = is_snp & (qps >= p.min_somatic_qual)
    if not p.include_loh:
        emit = emit & ~loh
    if not p.include_gor:
        emit = emit & ~gor

    # statuses (reference somatic_sniper.c:241-261)
    t_status = torch.where(
        tumor_eff == normal_eff, GERMLINE,
        torch.where(genotype_is_proper_subset(tumor_eff, normal_eff), LOH,
                    torch.where(qps > 0, SOMATIC, UNKNOWN)),
    ).to(I32)
    n_status = torch.where(n_b1 == rb4, WILDTYPE, GERMLINE).to(I32)

    dq_t = dq_n = None
    if tumor.encoding == "raw32":
        wanted = rb4 | tumor_eff | normal_eff
        dq_t = _device_dqstats(tumor.slots, tumor.n_keep, rb4, wanted)
        dq_n = _device_dqstats(normal.slots, normal.n_keep, rb4, wanted)
    return CallResult(
        emit=emit, tumor_gt=t_b1, normal_gt=n_b1, tumor_cnsq=t_s1,
        normal_cnsq=n_s1, tumor_vaq=tumor_snp_q, normal_vaq=normal_snp_q,
        somatic_score=qps, joint_tumor_gt=score.joint_tumor_gt,
        joint_normal_gt=score.joint_normal_gt,
        joint_cnsq=score.joint_consensus_quality, tumor_status=t_status,
        normal_status=n_status, tumor_eff_gt=tumor_eff,
        normal_eff_gt=normal_eff, tumor_depth=g_t.depth,
        normal_depth=g_n.depth, tumor_dq=dq_t, normal_dq=dq_n,
    )


def call_batch_compact(tumor: ColumnBatch, normal: ColumnBatch,
                       dtabs: DeviceTables, params: ModelParams,
                       max_emit: int) -> CompactResult:
    """call_batch + on-device compaction of the emitted rows
    (somatic.py:315-385).

    Row j holds the j-th emitted column (ascending batch index) for
    j < min(count, K), K = min(max_emit, B); the rest repeat column 0,
    like the JAX package's ``nonzero(size=K, fill_value=0)``.  The
    compaction is a scatter, so nothing waits on the device."""
    B = tumor.slots.shape[0]
    K = min(max_emit, B)
    res = call_batch(tumor, normal, dtabs, params)
    dev = res.emit.device
    emit_i = res.emit.to(I32)
    pos = torch.cumsum(emit_i, dim=0, dtype=I32) - emit_i
    # emitted column b goes to row pos[b] while it fits; the rest to a
    # dropped row K
    dest = torch.where(res.emit & (pos < K), pos, K).long()
    idx = torch.zeros(K + 1, dtype=torch.long, device=dev)
    idx.scatter_(0, dest, torch.arange(B, device=dev))
    idx = idx[:K]
    fields = torch.stack([getattr(res, f) for f in COMPACT_FIELDS], dim=1)
    dq = ([res.tumor_dq[idx].long(), res.normal_dq[idx].long()]
          if res.tumor_dq is not None else [])
    rows = torch.cat([idx[:, None], fields[idx].long(), *dq], dim=1).to(I32)
    return CompactResult(count=emit_i.sum(dtype=I32), rows=rows)


def call_batch_packed(stacked, meta, dtabs: DeviceTables,
                      params: ModelParams) -> CompactResult:
    """Fast-path entry over one packed slab; every emitted row fits
    (K = B).

    ``stacked`` [2, B, D] int32 raw kept-only lanes (tumor, normal);
    ``meta`` [3, B] int32 with ``meta[0] = ref16 << 24`` and
    ``meta[2] = d_t | d_n << 8 | nk_t << 16 | nk_n << 24`` (meta[1] is
    unused by the raw-lane layout).  Layout contract of
    io.native_api.slab_fill_pair."""
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"stacked: expected [2, B, D], got "
                         f"{tuple(stacked.shape)}")
    if stacked.shape[2] > MAX_D:
        raise ValueError(
            f"packed metadata requires D <= {MAX_D}, got {stacked.shape[2]}")
    ref16 = (meta[0] >> 24) & 0xF
    d_t = meta[2] & 0xFF
    d_n = (meta[2] >> 8) & 0xFF
    nk_t = (meta[2] >> 16) & 0xFF
    nk_n = (meta[2] >> 24) & 0xFF
    cb_t = ColumnBatch(slots=stacked[0], depth=d_t, ref16=ref16, n_keep=nk_t)
    cb_n = ColumnBatch(slots=stacked[1], depth=d_n, ref16=ref16, n_keep=nk_n)
    return call_batch_compact(cb_t, cb_n, dtabs, params,
                              max_emit=stacked.shape[1])


def call_batch_stacked(stacked, meta, dtabs: DeviceTables,
                       params: ModelParams, packed16: bool, max_emit: int,
                       compact: bool = True):
    """call_batch(_compact) over the batch path's upload layout
    (somatic.py:482-538).

    ``stacked`` [2, B, D] (tumor, normal): uint16 compact lanes when
    ``packed16``, else int32 full slot words.  ``meta`` int32 rows:
    ``[d_t, d_n, ref16, nk_t, nk_n, rms_t, rms_n]`` ([7, B]) when
    ``packed16``, else ``[d_t, d_n, ref16]`` ([3, B]).  Returns the
    CompactResult (K = min(max_emit, B)) when ``compact``, else the full
    CallResult."""
    want = (torch.uint16, 7) if packed16 else (I32, 3)
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"stacked: expected [2, B, D], got "
                         f"{tuple(stacked.shape)}")
    if stacked.dtype != want[0]:
        raise TypeError(f"stacked: expected {want[0]}, got {stacked.dtype}")
    if tuple(meta.shape) != (want[1], stacked.shape[1]):
        raise ValueError(f"meta: expected {(want[1], stacked.shape[1])}, "
                         f"got {tuple(meta.shape)}")
    if packed16:
        cb_t = ColumnBatch(slots=stacked[0], depth=meta[0], ref16=meta[2],
                           n_keep=meta[3], rms_sum=meta[5])
        cb_n = ColumnBatch(slots=stacked[1], depth=meta[1], ref16=meta[2],
                           n_keep=meta[4], rms_sum=meta[6])
    else:
        cb_t = ColumnBatch(slots=stacked[0], depth=meta[0], ref16=meta[2])
        cb_n = ColumnBatch(slots=stacked[1], depth=meta[1], ref16=meta[2])
    if compact:
        return call_batch_compact(cb_t, cb_n, dtabs, params,
                                  max_emit=max_emit)
    return call_batch(cb_t, cb_n, dtabs, params)
