"""Batched somatic calling in torch.

Port of somatic_sniper_tpu/models/somatic.py (:62-124, :137-274,
:279-385, :395-538): glfgen of both samples, then consensus, the
somatic score, the emission gates and the on-device dqstats (raw
kept-only lanes only) in one ``ops.score_kernels.score_columns`` call,
and compaction of the emitted sites into i32 rows for the slab path
(``call_batch_packed``) and the batch path (``call_batch_stacked``).
``precision`` chooses the glfgen alone (f32 kernels, or the reference's
f64 arithmetic over full u32 words); every step after it is integer
work and the same in both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..io.native_api import SLAB_MAX_D as MAX_D
from ..ops.score_kernels import ScoredColumns, score_columns
# parts of the plain version, re-exported under the names the JAX
# package gives them here
from ..ops.score_kernels import _device_dqstats, _mean_499  # noqa: F401
from .fields import COMPACT_FIELDS
from .glfgen import ColumnBatch, glfgen_lk
from .tables import DeviceTables, ModelParams

I32 = torch.int32

# the packed slab metadata carries depths and kept counts in bytes to
# depth MAX_D_NARROW, and in 16-bit halves of meta[1] and meta[2] above
# it, to MAX_D (the native fill's bound).  The byte layout is the JAX
# package's packed layout: the tests hold both packages' native fills and
# packed entries to each other on one slab (tests/test_torch_host_layer.py,
# tests/test_torch_somatic.py), and utils/mfu.bench_kernel builds it.
# Both layouts upload the same three words a column.
MAX_D_NARROW = 255


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
    # [] int32, non-zero when a class count fell outside the assembly
    # tables (a fast batch deeper than 255); None where none can
    err: torch.Tensor | None = None


class CompactResult(NamedTuple):
    """Emitted rows first, in ascending batch index; rows past ``count``
    repeat column 0.  ``rows`` is [K, 1 + 16 (+ 36)] int32: the batch
    index, the COMPACT_FIELDS, then tumor and normal dqstats when the
    lanes carry them, with K = min(max_emit, B).  ``count`` may exceed
    K, and the caller then refetches the full CallResult.  ``err`` is
    the CallResult's error word, the device's constant 0 where it has
    none: the caller reads it with ``count`` and raises if it is set.
    The JAX package's byte-narrow u8 rows hid a slow device-to-host
    link, which a card on the host's PCIe does not have."""

    count: torch.Tensor  # [] int32
    rows: torch.Tensor
    err: torch.Tensor  # [] int32


@functools.lru_cache(maxsize=None)
def _no_error(device: torch.device) -> torch.Tensor:
    """The error word of a step that has none: a 0 made once a device,
    so that a warm step makes no tensor (models/consensus._consts)."""
    return torch.zeros((), dtype=I32, device=device)


def _score(tumor: ColumnBatch, normal: ColumnBatch, dtabs: DeviceTables,
           params: ModelParams, precision: str):
    """(ScoredColumns, err) of a batch: glfgen of both samples, then
    ``score_columns``, one kernel for everything after it."""
    lk_t, n_t, err_t = glfgen_lk(tumor, dtabs, params.cap_mapq, precision)
    lk_n, n_n, err_n = glfgen_lk(normal, dtabs, params.cap_mapq, precision)
    err = None if err_t is None else torch.maximum(err_t, err_n)[0]
    dq_lanes = ((tumor.slots, tumor.n_keep, normal.slots, normal.n_keep)
                if tumor.encoding == "raw32" else None)
    scored = score_columns(lk_t, lk_n, tumor.depth, normal.depth, n_t, n_n,
                           tumor.ref16, dtabs.solo_prior, dtabs.joint_prior,
                           dtabs.q_r_int, params, dq_lanes)
    return scored, err


def call_batch(tumor: ColumnBatch, normal: ColumnBatch, dtabs: DeviceTables,
               params: ModelParams, precision: str = "fast") -> CallResult:
    """Batched glf_somatic (reference somatic_sniper.c:109-273), with
    the dqstats rows of both samples when the lanes are raw kept-only
    words (the other encodings cannot give them, somatic.py:239-252).
    ``dtabs`` holds the tables of ``precision``.  A set ``err`` (a fast
    batch deeper than 255 with a count outside the tables,
    ``glfgen_batch``) means the result is not to be used: the caller
    reads it and raises, as ``runner.collect_pending`` does.  The 16
    fields are columns of one [B, 16] tensor (``ops.score_kernels``)."""
    scored, err = _score(tumor, normal, dtabs, params, precision)
    return CallResult(scored.emit, *scored.fields.unbind(1),
                      tumor_dq=scored.tumor_dq, normal_dq=scored.normal_dq,
                      err=err)


def call_batch_compact(tumor: ColumnBatch, normal: ColumnBatch,
                       dtabs: DeviceTables, params: ModelParams,
                       max_emit: int,
                       precision: str = "fast") -> CompactResult:
    """call_batch + on-device compaction of the emitted rows
    (somatic.py:315-385).

    Row j holds the j-th emitted column (ascending batch index) for
    j < min(count, K), K = min(max_emit, B); the rest repeat column 0,
    like the JAX package's ``nonzero(size=K, fill_value=0)``.  The
    compaction is a scatter, so nothing waits on the device."""
    scored, err = _score(tumor, normal, dtabs, params, precision)
    return _compact(scored, err, max_emit)


def compact_rows(res: CallResult, max_emit: int) -> CompactResult:
    """The compaction of call_batch_compact over a CallResult already
    scored."""
    fields = torch.stack([getattr(res, f) for f in COMPACT_FIELDS], dim=1)
    return _compact(ScoredColumns(res.emit, fields, res.tumor_dq,
                                  res.normal_dq), res.err, max_emit)


def _compact(scored: ScoredColumns, err, max_emit: int) -> CompactResult:
    B = scored.emit.shape[0]
    K = min(max_emit, B)
    dev = scored.emit.device
    emit_i = scored.emit.to(I32)
    pos = torch.cumsum(emit_i, dim=0, dtype=I32) - emit_i
    # emitted column b goes to row pos[b] while it fits; the rest to a
    # dropped row K
    dest = torch.where(scored.emit & (pos < K), pos, K).long()
    idx = torch.zeros(K + 1, dtype=torch.long, device=dev)
    idx.scatter_(0, dest, torch.arange(B, device=dev))
    idx = idx[:K]
    dq = ([scored.tumor_dq[idx].long(), scored.normal_dq[idx].long()]
          if scored.tumor_dq is not None else [])
    rows = torch.cat([idx[:, None], scored.fields[idx].long(), *dq],
                     dim=1).to(I32)
    return CompactResult(count=emit_i.sum(dtype=I32), rows=rows,
                         err=_no_error(dev) if err is None else err)


def packed_column_batches(stacked, meta) -> tuple[ColumnBatch, ColumnBatch]:
    """(tumor, normal) raw kept-only batches of one packed slab, on the
    device the slab lies on.

    ``stacked`` [2, B, D] int32 raw kept-only lanes (tumor, normal);
    ``meta`` [3, B] int32 with ``meta[0] = ref16 << 24``.  To depth
    ``MAX_D_NARROW`` (255) ``meta[2] = d_t | d_n << 8 | nk_t << 16 |
    nk_n << 24`` and meta[1] is unused; deeper, to ``MAX_D`` (65535),
    ``meta[1] = d_t | d_n << 16`` and ``meta[2] = nk_t | nk_n << 16``.
    Layout contract of io.native_api.slab_fill_pair."""
    if stacked.dim() != 3 or stacked.shape[0] != 2:
        raise ValueError(f"stacked: expected [2, B, D], got "
                         f"{tuple(stacked.shape)}")
    D = stacked.shape[2]
    if D > MAX_D:
        raise ValueError(
            f"packed metadata requires D <= {MAX_D}, got {D}")
    ref16 = (meta[0] >> 24) & 0xF
    if D <= MAX_D_NARROW:
        d_t = meta[2] & 0xFF
        d_n = (meta[2] >> 8) & 0xFF
        nk_t = (meta[2] >> 16) & 0xFF
        nk_n = (meta[2] >> 24) & 0xFF
    else:
        d_t = meta[1] & 0xFFFF
        d_n = (meta[1] >> 16) & 0xFFFF
        nk_t = meta[2] & 0xFFFF
        nk_n = (meta[2] >> 16) & 0xFFFF
    return (ColumnBatch(slots=stacked[0], depth=d_t, ref16=ref16,
                        n_keep=nk_t),
            ColumnBatch(slots=stacked[1], depth=d_n, ref16=ref16,
                        n_keep=nk_n))


def call_batch_packed(stacked, meta, dtabs: DeviceTables,
                      params: ModelParams) -> CompactResult:
    """Fast-path entry over one packed slab (layout of
    packed_column_batches); every emitted row fits (K = B).  A slab
    deeper than 255 takes the c_tot > 255 rescale (``glfgen_batch``),
    and the result's ``err`` must then be read with its rows."""
    cb_t, cb_n = packed_column_batches(stacked, meta)
    return call_batch_compact(cb_t, cb_n, dtabs, params,
                              max_emit=stacked.shape[1])


def stacked_column_batches(stacked, meta,
                           packed16: bool) -> tuple[ColumnBatch, ColumnBatch]:
    """(tumor, normal) batches of the batch path's upload layout, on the
    device it lies on.

    ``stacked`` [2, B, D] (tumor, normal): uint16 compact lanes when
    ``packed16``, else int32 full slot words.  ``meta`` int32 rows:
    ``[d_t, d_n, ref16, nk_t, nk_n, rms_t, rms_n]`` ([7, B]) when
    ``packed16``, else ``[d_t, d_n, ref16]`` ([3, B])."""
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
    return cb_t, cb_n


def call_batch_stacked(stacked, meta, dtabs: DeviceTables,
                       params: ModelParams, packed16: bool, max_emit: int,
                       compact: bool = True, precision: str = "fast"):
    """call_batch(_compact) over the batch path's upload layout
    (somatic.py:482-538; layout of stacked_column_batches).  Returns the
    CompactResult (K = min(max_emit, B)) when ``compact``, else the full
    CallResult.  Exact precision reads full slot words only.  Either
    result's ``err`` must be read, as ``call_batch`` says."""
    cb_t, cb_n = stacked_column_batches(stacked, meta, packed16)
    if compact:
        return call_batch_compact(cb_t, cb_n, dtabs, params,
                                  max_emit=max_emit, precision=precision)
    return call_batch(cb_t, cb_n, dtabs, params, precision)
