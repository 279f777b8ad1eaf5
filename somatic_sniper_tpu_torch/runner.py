"""Single-host calling driver of the torch port: BAM pair -> output lines.

The host helpers below are jax-free copies of somatic_sniper_tpu/runner.py
(the port imports nothing of the JAX package); each names its source
lines.  The device path
is the port's: ``TorchSlabDispatcher`` and the batch path
(``submit_batches`` / ``collect_pending``) over ``models.somatic``; on
a card each replays a captured CUDA graph of its scoring step a shape
(``models.step_graph``).

Exact precision with native pileups and a reference runs entirely in
the native host layer, as in the JAX package.  Fast precision with them
plans natively, then scores the survivors on the device in uniform
slabs; columns deeper than the slab depth are scored exactly on the
host.  Without them (no native library: pure-Python decode and
columnize; no reference) both precisions take the batch path: every
shared column, bucketed by depth, is scored on the device, fast in u16
batches (with a reference) or full-u32 batches (without one), exact in
full-u32 batches through the f64 glfgen.  The JAX package pins that
exact compute to the host CPU because its accelerator emulates f64; a
GPU has f64 units, so here it runs on the device the caller names.

A process scores on the one device it is given.  Several GPUs are
reached through several processes: ``--shards`` / ``--shard-index``
with a card each in ``CUDA_VISIBLE_DEVICES`` (``--jobs`` puts every
worker on the first card).

This module imports torch, and the modules that import it, only inside
the functions that make a tensor: the all-host exact run
(``exact_records_native``) completes without torch, and with ``fmt``
left None every route builds ``SniperRecord`` objects in place of text
lines (``_build_records``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterator

import numpy as np

from .constants import NT16_TABLE
from .device import resolve_device
from .io import native_api
from .io.bam import BamHeader, read_bam, read_bam_header
from .io.fasta import FastaFile
from .models.fields import COMPACT_FIELDS
from .models.tables import (DeviceTables, ModelParams, build_tables,
                            device_tables)
from .output.dqstats import (get_dqstats_batch, get_dqstats_rows,
                             rows_to_dqstats)
from .output.records import SampleData, SniperRecord
from .pileup.columnize import (DEPTH_BUCKETS, PairedBatch, columnize,
                               paired_batches, split_key)
from .pileup.prefilter import build_ref16, prefilter_tables, pure_flags
from .utils.stats import STATS

if TYPE_CHECKING:  # models.somatic imports torch
    from .models.somatic import CallResult

# rows a batch's compact result holds (runner.py:807); a batch that
# emits more is refetched whole
MAX_EMIT = 16384
# columns a batch holds at most (runner.py:399)
MAX_BATCH = 65536


@dataclass
class RefCache:
    """Per-tid reference fetch cache (runner.py:47-71); thread-safe."""

    fasta: FastaFile | None
    header: BamHeader

    def __post_init__(self):
        self._tid = -1
        self._seq: bytes | None = None
        self._lock = threading.Lock()

    def get(self, tid: int) -> bytes | None:
        with self._lock:
            if tid != self._tid:
                name = self.header.ref_names[tid]
                self._seq = self.fasta.fetch(name) if self.fasta else None
                self._tid = tid
            return self._seq


class NativeUnavailable(RuntimeError):
    """A run that needs the native host library found none."""


def require_native(what: str) -> None:
    """Raise unless the native host library loads: the region loads of
    ``parallel.sharded`` need it."""
    if not native_api.available():
        raise NativeUnavailable(
            f"{what} needs the native host library "
            "(somatic_sniper_tpu_torch/io/native), which is unavailable")


def _load_pileups(tumor_bam, normal_bam, params, flag_args=None):
    """Decode + columnize both BAMs (runner.py:203-230): natively, one OS
    thread per file; without the native library, the pure-Python decode
    and columnize (no load-time flags)."""
    if not native_api.available():
        with STATS.timer("decode"):
            header_t, reads_t = read_bam(tumor_bam)
            header_n, reads_n = read_bam(normal_bam)
            pu_t = columnize(reads_t, params.flag_mask,
                             params.mapq_threshold)
            pu_n = columnize(reads_n, params.flag_mask,
                             params.mapq_threshold)
        return header_t, pu_t, header_n, pu_n
    from concurrent.futures import ThreadPoolExecutor

    per_file = max(1, (os.cpu_count() or 2) // 2)
    with STATS.timer("decode"), ThreadPoolExecutor(max_workers=2) as ex:
        f_t = ex.submit(native_api.load_and_columnize, tumor_bam,
                        params.flag_mask, params.mapq_threshold, per_file,
                        flag_args)
        f_n = ex.submit(native_api.load_and_columnize, normal_bam,
                        params.flag_mask, params.mapq_threshold, per_file,
                        flag_args)
        header_t, pu_t = f_t.result()
        header_n, pu_n = f_n.result()
    return header_t, pu_t, header_n, pu_n


def _ref_blob(fasta, header):
    """Whole-genome 4-bit reference blob, or (None, None) without a ref
    (runner.py:233-245)."""
    if fasta is None:
        return None, None
    seqs = []
    for name in header.ref_names:
        try:
            seqs.append(fasta.fetch(name) or b"")
        except Exception:
            seqs.append(b"")
    return build_ref16(seqs)


def can_plan(pu_t, pu_n, packed16: bool) -> bool:
    """The fused native plan path applies (runner.py:421-430)."""
    return (
        packed16
        and pu_t.owner is not None
        and hasattr(pu_t.owner, "pad16_into")
        and pu_n.owner is not None
        and hasattr(pu_n.owner, "pad16_into")
    )


def can_exact_native(pu_t, pu_n, ref_blob) -> bool:
    """The all-host exact scorer applies (runner.py:433-442)."""
    return (
        ref_blob is not None
        and pu_t.owner is not None
        and getattr(pu_t.owner, "_ptr", None) is not None
        and pu_n.owner is not None
        and getattr(pu_n.owner, "_ptr", None) is not None
    )


def make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, prefilter: bool,
              cns_mode: str = "full"):
    """One native ``paired_plan`` pass (runner.py:555-584): ukey
    intersection, the pure-reference prefilter, the dual-consensus gate
    and depth grouping.  ``cns_mode="full"`` evaluates the gate with the
    f64 model; ``"proof"`` leaves unresolved columns to the full scoring
    behind the plan, which applies the whole gate (every caller here
    scores behind it, so all pass ``"proof"``).  Without ``prefilter``
    neither the pure-reference tables nor the gate's go to the plan and
    every common column survives.  ``SNIPER_PLAN_GATE=full|proof``
    overrides ``cns_mode``."""
    cns_mode = os.environ.get("SNIPER_PLAN_GATE", cns_mode)
    gmin, margin = None, 0.0
    coef = lhet = None
    if prefilter:
        pt = prefilter_tables(tabs)
        if pt is not None:
            gmin, margin = pt
        coef, lhet = tabs.coef, tabs.lhet
    with STATS.timer("plan"):
        plan = native_api.paired_plan(
            pu_t, pu_n, ref_blob, ref_off, DEPTH_BUCKETS, fk=tabs.fk,
            gmin=gmin, margin=margin, coef=coef, lhet=lhet,
            q_r_int=tabs.q_r_int, cns_mode=cns_mode)
    STATS.add("columns_scored", len(plan.keys))
    return plan


def exact_records_native(pu_t, pu_n, tabs, ref_blob, ref_off, refcache,
                         fmt: str | None = None, plan=None,
                         prefilter: bool = True) -> list[tuple[int, object]]:
    """Exact mode entirely in the native layer: plan, then full f64 and
    integer scoring of every survivor (runner.py:517-552).  Returns
    (column key, output line of ``fmt``) pairs in coordinate order, or
    (column key, SniperRecord) pairs when ``fmt`` is None."""
    if plan is None:
        plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, prefilter,
                         cns_mode="proof")
    p = tabs.params
    with STATS.timer("score"):
        rows = native_api.exact_pair_rows(
            pu_t, pu_n, plan.ti, plan.ni, plan.ref16, tabs,
            p.use_joint_priors, p.min_somatic_qual, p.include_loh,
            p.include_gor,
        )
    with STATS.timer("emit"):
        records = emit_records_compact(
            np.asarray(plan.keys, np.int64), rows,
            np.asarray(plan.ref16, np.int64), pu_t, pu_n, refcache, fmt)
    records.sort(key=lambda kv: kv[0])
    STATS.add("records_emitted", len(records))
    return records


def call_pair(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    fmt: str | None = None,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    device=None,
    max_batch: int = MAX_BATCH,
    prefilter: bool = True,
) -> Iterator:
    """Whole-file run (runner.py:286-398), in coordinate order: the
    output lines of ``fmt`` ("classic"/"vcf"/"bed"), or ``SniperRecord``
    objects when ``fmt`` is None (formatting them gives the same bytes;
    the lines are the cheaper bulk path).  ``prefilter=False`` scores
    every column the two samples share; the records are the same.

    ``device`` (a ``torch.device`` or its name) scores the fast path's
    slabs or batches, and the exact path's batches where the native host
    scorer does not apply (no native library, no reference).  It is
    resolved where a path first needs it (``device.resolve_device``: a
    CUDA device that is absent raises, nothing falls back to the CPU);
    exact precision with native pileups and a reference never resolves
    it, so that run needs neither a card nor torch."""
    if precision == "fast":
        if device is None:
            raise ValueError("fast precision needs a device")
        device = resolve_device(device)
    fasta = FastaFile(ref_fasta) if ref_fasta else None
    tabs = build_tables(params)
    flag_args = None
    ref_blob = ref_off = None
    hdr_path = normal_bam if tumor_bam == "-" else tumor_bam
    if fasta is not None and hdr_path != "-":
        # reference blob before the load: the loader threads compute the
        # pure-reference flags alongside the pileup build
        try:
            ref_blob, ref_off = _ref_blob(fasta, read_bam_header(hdr_path))
            pt = prefilter_tables(tabs) if prefilter else None
            if pt is not None:
                gmin, margin = pt
                flag_args = (ref_blob, ref_off, tabs.fk, gmin, margin)
        except Exception:
            ref_blob = ref_off = None
    header_t, pu_t, header_n, pu_n = _load_pileups(
        tumor_bam, normal_bam, params, flag_args)
    refcache = RefCache(fasta, header_t)
    if ref_blob is None:
        ref_blob, ref_off = _ref_blob(fasta, header_t)
    if precision == "exact" and can_exact_native(pu_t, pu_n, ref_blob):
        for _, rec in exact_records_native(
                pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt,
                prefilter=prefilter):
            yield rec
        return
    # u16 batches carry '=' resolved against the reference; without
    # one the batch path ships full u32 slots, as the exact path always
    # does
    packed16 = precision == "fast" and ref_blob is not None
    if not can_plan(pu_t, pu_n, packed16):
        if device is None:
            raise ValueError("exact precision without native pileups and a "
                             "reference scores on a device: name one")
        device = resolve_device(device)
        dtabs = device_tables(tabs, device, precision)
        drop_t = drop_n = None
        if prefilter:
            drop_t, drop_n = _prefilter_flags(pu_t, pu_n, ref_blob, ref_off,
                                              tabs)
        ref16_fn = _make_ref16_fn(ref_blob, ref_off) if packed16 else None
        pending = submit_batches(pu_t, pu_n, refcache, dtabs, device,
                                 drop_t, drop_n, packed16, ref16_fn,
                                 params.cap_mapq, max_batch=max_batch,
                                 precision=precision)
        for _, rec in collect_pending(pending, pu_t, pu_n, refcache,
                                      dtabs, device, fmt,
                                      precision=precision):
            yield rec
        return
    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off, prefilter,
                     cns_mode="proof")
    from .parallel.slab import TorchSlabDispatcher

    disp = TorchSlabDispatcher(
        lambda: device_tables(tabs, device), tabs, params, refcache,
        device, fmt,
    )
    disp.add_window(0, None, pu_t, pu_n, plan)
    for _, _, recs in disp.finish():
        yield from recs


def _ref_arrays(batch: PairedBatch, refcache: RefCache):
    """Raw ref char + 4-bit code per column of a batch (runner.py:74-89)."""
    tids, poss = split_key(batch.keys)
    chars = np.full(len(tids), ord("N"), np.int32)
    for tid in np.unique(tids):
        seq = refcache.get(int(tid))
        m = tids == tid
        if seq is None:
            continue
        p = poss[m]
        ok = p < len(seq)
        arr = np.frombuffer(seq, dtype=np.uint8)
        chars[m] = np.where(ok, arr[np.minimum(p, len(seq) - 1)], ord("N"))
    return chars, NT16_TABLE[chars].astype(np.int32)


def _make_ref16_fn(ref_blob, ref_off):
    """keys -> int32[B] reference-code lookup over the blob ('N' = 15 for
    out-of-range positions, matching _ref_arrays) (runner.py:248-265)."""
    lens = np.diff(ref_off)
    n_ref = len(lens)

    def fn(keys):
        tid = (keys >> 40).astype(np.int64)
        pos = (keys & ((1 << 40) - 1)).astype(np.int64)
        ok = (tid >= 0) & (tid < n_ref)
        tid_c = np.clip(tid, 0, max(n_ref - 1, 0))
        ok &= pos < lens[tid_c]
        addr = ref_off[tid_c] + np.minimum(
            pos, np.maximum(lens[tid_c] - 1, 0))
        return np.where(ok, ref_blob[addr], 15).astype(np.int32)

    return fn


def _prefilter_flags(pu_t, pu_n, ref_blob, ref_off, tabs):
    """(drop_tumor, drop_normal) pure-reference flags, or (None, None)
    (runner.py:268-283)."""
    pt = prefilter_tables(tabs)
    if pt is None or ref_blob is None:
        return None, None
    ft = native_api.precomputed_pure(pu_t)
    fn = native_api.precomputed_pure(pu_n)
    if ft is not None and fn is not None:
        return ft, fn
    gmin, margin = pt
    with STATS.timer("prefilter"):
        ft = pure_flags(pu_t, ref_blob, ref_off, tabs.fk, gmin, margin)
        fn = pure_flags(pu_n, ref_blob, ref_off, tabs.fk, gmin, margin)
    return ft, fn


def _pad_b(arr: np.ndarray, B: int) -> np.ndarray:
    """Pad the leading (batch) axis to B with zeros (runner.py:719-724)."""
    if arr.shape[0] == B:
        return arr
    pad = [(0, B - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def _b_bucket(b: int, minimum: int = 256) -> int:
    """The padded batch size of ``b`` columns (runner.py:737-747):
    powers of two from ``minimum`` to 2048, then multiples of 2048.
    Each bucket is one captured step a (D, encoding, precision), as it
    was one XLA executable in the JAX package."""
    B = minimum
    while B < b and B < 2048:
        B *= 2
    if B >= b:
        return B
    return ((b + 2047) // 2048) * 2048


def submit_call_batch(batch: PairedBatch, ref16: np.ndarray,
                      dtabs: DeviceTables, device, compact: bool = True,
                      precision: str = "fast"):
    """Upload one batch and score it on ``device`` (runner.py:750-812),
    without waiting for it: one stacked upload of the two slot arrays
    (u16 stays u16, half the bytes) and one of the metadata rows, the
    batch axis padded to its bucket (``_b_bucket``) with empty columns
    (depth 0: they never emit).  Returns the on-device CompactResult
    (i32 rows, K = min(MAX_EMIT, bucket)) when ``compact``, else the
    full CallResult of the batch's own columns.

    Each compact batch takes one of two routes, counted in STATS:

    * on a card the key's captured step (``models/step_graph
      .STEP_GRAPHS.run_batch``), every depth and both precisions: a
      key's first batch eagerly (``batches_eager_first``), its second
      captured (``batch_captures``), the others replayed; every batch
      that replays counts in ``batches_graphed``;
    * on the CPU the eager step over the plain versions
      (``batches_eager_cpu``).

    A fast batch deeper than ``MAX_D`` leaves the stand-alone
    ``assembly10``'s error word on the device, in the CompactResult's
    ``err``; ``collect_pending`` reads it with the counts.  The full
    CallResult (the overflow refetch, ``run_call_batch``) is scored
    eagerly.  A failed capture or replay raises: nothing scores the
    batch eagerly in its place."""
    import torch

    from .models import step_graph
    from .models.somatic import (CallResult, call_batch, compact_rows,
                                 stacked_column_batches)

    b0 = len(batch.keys)
    B = _b_bucket(b0)
    stacked_h = np.stack([_pad_b(batch.tumor, B), _pad_b(batch.normal, B)])
    meta_rows = [batch.n_tumor, batch.n_normal, ref16]
    if batch.packed16:
        meta_rows += [batch.nk_tumor, batch.nk_normal, batch.rms_tumor,
                      batch.rms_normal]
    else:
        stacked_h = stacked_h.view(np.int32)
    meta_h = np.stack([_pad_b(np.asarray(r, np.int32), B)
                       for r in meta_rows])
    STATS.add("device_columns", b0)
    device = torch.device(device)
    graphs = step_graph.STEP_GRAPHS
    if compact and graphs.captures_on(device):
        spec = step_graph.StepSpec(batch.packed16, precision,
                                   min(MAX_EMIT, B))
        route, res = graphs.run_batch(stacked_h, meta_h, dtabs, dtabs.params,
                                      spec, device)
        STATS.add("batches_eager_first" if route == "first"
                  else "batches_graphed", 1)
        if route == "capture":
            STATS.add("batch_captures", 1)
        STATS.add(f"batch_key_{'u16' if batch.packed16 else 'u32'}_"
                  f"{precision}_{B}x{stacked_h.shape[2]}", 1)
        return res
    with STATS.timer("device.upload"):
        stacked = torch.from_numpy(stacked_h).to(device)
        meta = torch.from_numpy(meta_h).to(device)
    with STATS.timer("device.score"):
        res = call_batch(*stacked_column_batches(stacked, meta,
                                                 batch.packed16),
                         dtabs, dtabs.params, precision)
    if not compact:
        return CallResult(*(v if v is None or name == "err" else v[:b0]
                            for name, v in res._asdict().items()))
    STATS.add("batches_eager_cpu", 1)
    return compact_rows(res, MAX_EMIT)


def run_call_batch(batch: PairedBatch, ref16: np.ndarray,
                   dtabs: DeviceTables, device,
                   precision: str = "fast") -> CallResult:
    """Synchronous wrapper over submit_call_batch (runner.py:815-819):
    the full CallResult of one batch as numpy arrays on the host, all
    fields brought home in one copy, the error word beside them (a set
    one raises ValueError, as in ``collect_pending``)."""
    import torch

    from .models.somatic import CallResult

    res = submit_call_batch(batch, ref16, dtabs, device, compact=False,
                            precision=precision)
    live = {name: v for name, v in res._asdict().items()
            if v is not None and name != "err"}
    B = len(batch.keys)
    cols = [v.reshape(B, -1).to(torch.int32) for v in live.values()]
    if res.err is not None:
        cols.append(res.err.to(torch.int32).expand(B, 1))
    host = torch.cat(cols, dim=1).cpu().numpy()
    if res.err is not None:
        _raise_on_count_error(host[:1, -1], [batch.tumor.shape[1]])
    ends = np.cumsum([c.shape[1] for c in cols])
    out = {}
    for (name, v), part in zip(live.items(), np.split(host, ends[:-1], 1)):
        out[name] = part if v.dim() == 2 else part[:, 0]
    out["emit"] = out["emit"].astype(bool)
    return CallResult(**out)


def _raise_on_count_error(errs, depths) -> None:
    """Raise the stand-alone ``assembly10``'s ValueError for the first
    batch whose error word is set (a class count outside the assembly
    tables of its depth D)."""
    from .ops.glfgen_kernels import MAX_D, _count_error

    for err, D in zip(errs, depths):
        if err:
            raise ValueError(_count_error(min(D, MAX_D) + 1))


def submit_batches(pu_t, pu_n, refcache, dtabs, device, drop_t, drop_n,
                   packed16, ref16_fn, cap_mapq,
                   max_batch: int = MAX_BATCH,
                   precision: str = "fast") -> list:
    """Score every paired batch on the device (runner.py:399-418);
    returns the pending list for collect_pending, which fetches the
    rows.  Only counts, error words and rows wait for the device: the
    kernels queue on its stream, at every depth."""
    pending = []
    batches = paired_batches(pu_t, pu_n, max_batch=max_batch,
                             drop_tumor=drop_t, drop_normal=drop_n,
                             packed16=packed16, ref16_fn=ref16_fn,
                             cap_mapq=cap_mapq)
    while True:
        with STATS.timer("batch_build"):
            batch = next(batches, None)
            if batch is None:
                break
            _, ref16 = _ref_arrays(batch, refcache)
        res = submit_call_batch(batch, ref16, dtabs, device,
                                precision=precision)
        STATS.add("batches_dispatched", 1)
        STATS.add(f"batch_columns_at_depth_{batch.tumor.shape[1]}",
                  len(batch.keys))
        pending.append((batch, ref16, res))
    return pending


def collect_pending(pending, pu_t, pu_n, refcache, dtabs, device,
                    fmt: str | None = None,
                    precision: str = "fast") -> list[tuple[int, object]]:
    """Fetch the compacted results and build the output lines (the
    records when ``fmt`` is None), sorted by column key
    (runner.py:624-698).  The counts and the error words come home in
    one copy, then each batch's first ``count`` rows (torch slices them
    exactly, so the JAX package's power-of-two fetch buckets,
    ``_emit_bucket`` :727-734, are not needed).  A set error word (a
    fast batch deeper than 255 whose class counts fell outside the
    assembly tables) raises the stand-alone ``assembly10``'s ValueError
    here.  A batch that emitted more rows than its compact result holds
    is scored again in full and emitted from the CallResult."""
    import torch

    records: list[tuple[int, object]] = []
    if not pending:
        return records
    with STATS.timer("device"):
        words = torch.stack([w for p in pending
                             for w in (p[2].count, p[2].err)]).cpu()
    counts, errs = words[0::2].tolist(), words[1::2].tolist()
    _raise_on_count_error(errs, [p[0].tumor.shape[1] for p in pending])
    for (batch, ref16, res), count in zip(pending, counts):
        if count <= 0:
            continue
        if count > res.rows.shape[0]:
            full = submit_call_batch(batch, ref16, dtabs, device,
                                     compact=False, precision=precision)
            STATS.add("batches_refetched", 1)
            with STATS.timer("emit"):
                records.extend(emit_records(batch.keys, full, ref16, pu_t,
                                            pu_n, refcache, fmt))
            continue
        with STATS.timer("device.rows"):
            rows = res.rows[:count].cpu().numpy()
        with STATS.timer("emit"):
            records.extend(emit_records_compact(batch.keys, rows, ref16,
                                                pu_t, pu_n, refcache, fmt))
    records.sort(key=lambda kv: kv[0])
    STATS.add("records_emitted", len(records))
    return records


def emit_records(keys: np.ndarray, res: CallResult, ref16: np.ndarray,
                 pu_t, pu_n, refcache: RefCache,
                 fmt: str | None = None) -> list[tuple[int, object]]:
    """(column key, line or record) pairs of the emitted columns of a
    full CallResult, tensors or host arrays (runner.py:822-838)."""
    def host(v):
        return np.asarray(v.cpu() if hasattr(v, "cpu") else v)

    idx = np.nonzero(host(res.emit))[0]
    if len(idx) == 0:
        return []
    f = {name: host(getattr(res, name))[idx].astype(np.int64)
         for name in COMPACT_FIELDS}
    rows_t = rows_n = None
    if res.tumor_dq is not None:
        rows_t = host(res.tumor_dq)[idx].astype(np.int64)
        rows_n = host(res.normal_dq)[idx].astype(np.int64)
    return _build_records(keys, idx, f, ref16, pu_t, pu_n, refcache, fmt,
                          rows_t, rows_n)


def _ref_chars_for(keys: np.ndarray, refcache: RefCache) -> np.ndarray:
    """Raw reference characters for column keys (runner.py:701-716)."""
    tids = (keys >> 40).astype(np.int64)
    poss = (keys & ((1 << 40) - 1)).astype(np.int64)
    chars = np.full(len(keys), ord("N"), np.int32)
    for tid in np.unique(tids):
        seq = refcache.get(int(tid))
        if seq is None:
            continue
        m = tids == tid
        p = poss[m]
        ok = p < len(seq)
        arr = np.frombuffer(seq, dtype=np.uint8)
        chars[m] = np.where(ok, arr[np.minimum(p, len(seq) - 1)], ord("N"))
    return chars


def emit_records_compact(keys: np.ndarray, rows: np.ndarray,
                         ref16: np.ndarray, pu_t, pu_n, refcache: RefCache,
                         fmt: str | None = None) -> list[tuple[int, object]]:
    """(column key, line or record) pairs from an emitted-row matrix
    [count, 1 + NF (+ 36)] (runner.py:841-867): leading column the index
    into ``keys``/``ref16``, then the COMPACT_FIELDS, then (when present)
    the tumor and normal dqstats (computed on the device for slab
    columns, appended by the host for a slab's deep columns);
    without them the builder walks the pileups."""
    if len(rows) == 0:
        return []
    idx = rows[:, 0].astype(np.int64)
    nf = len(COMPACT_FIELDS)
    f = {name: rows[:, 1 + j] for j, name in enumerate(COMPACT_FIELDS)}
    rows_t = rows_n = None
    if rows.shape[1] == 1 + nf + 36:
        rows_t = rows[:, 1 + nf:1 + nf + 18]
        rows_n = rows[:, 1 + nf + 18:1 + nf + 36]
    return _build_records(keys, idx, f, ref16, pu_t, pu_n, refcache, fmt,
                          rows_t, rows_n)


def _build_records(keys: np.ndarray, idx: np.ndarray, f: dict,
                   ref16: np.ndarray, pu_t, pu_n, refcache: RefCache,
                   fmt: str | None = None, rows_t: np.ndarray | None = None,
                   rows_n: np.ndarray | None = None
                   ) -> list[tuple[int, object]]:
    """The one builder behind every route (runner.py:870-992): ``f``
    holds the COMPACT_FIELDS of the emitted columns ``idx`` of
    ``keys``/``ref16``, ``rows_t``/``rows_n`` their [count, 18] dqstats
    rows where the scorer supplied them.  With ``fmt`` the bulk text
    path: the native ``emit_lines`` in one pass, else the Python line
    builders of ``output.fast_emit``.  With ``fmt`` None, ``DqStats`` /
    ``SampleData`` / ``SniperRecord`` objects, which the formatters of
    ``output.formatters`` render to the same bytes."""
    keys = keys[idx]
    tids = (keys >> 40).astype(np.int64)
    poss = (keys & ((1 << 40) - 1)).astype(np.int64)
    chars = _ref_chars_for(keys, refcache)
    rb4 = ref16[idx].astype(np.int64)
    names = refcache.header.ref_names
    have_dq = rows_t is not None and rows_n is not None
    if not have_dq:
        wanted = rb4 | f["tumor_eff_gt"] | f["normal_eff_gt"]
        ci_t = np.searchsorted(pu_t.ukeys, keys)
        ci_n = np.searchsorted(pu_n.ukeys, keys)
    if fmt is not None:
        if not have_dq:
            with STATS.timer("emit.dqstats"):
                rows_t = get_dqstats_rows(pu_t, ci_t, rb4, wanted)
                rows_n = get_dqstats_rows(pu_n, ci_n, rb4, wanted)
        fields = np.stack(
            [np.asarray(f[k], np.int64) for k in COMPACT_FIELDS[:12]],
            axis=1)
        lines = native_api.emit_lines(fmt, names, tids, poss, chars, rb4,
                                      fields, rows_t, rows_n)
        if lines is None:  # non-ASCII reference names: the Python builders
            from .output.fast_emit import LINE_BUILDERS

            fl = {k: np.asarray(v).tolist() for k, v in f.items()}
            lines = LINE_BUILDERS[fmt](
                [names[t] for t in tids.tolist()], poss.tolist(),
                chars.tolist(), rb4.tolist(), fl, rows_t.tolist(),
                rows_n.tolist(),
            )
        return list(zip(keys.tolist(), lines))
    if have_dq:
        dq_t = rows_to_dqstats(rows_t)
        dq_n = rows_to_dqstats(rows_n)
    else:
        with STATS.timer("emit.dqstats"):
            dq_t = get_dqstats_batch(pu_t, ci_t, rb4, wanted)
            dq_n = get_dqstats_batch(pu_n, ci_n, rb4, wanted)
    # one .tolist() a field, not an int() a value
    fl = {k: np.asarray(v).tolist() for k, v in f.items()}
    names_l = [names[t] for t in tids.tolist()]
    poss_l, chars_l, rb4_l = poss.tolist(), chars.tolist(), rb4.tolist()
    out = []
    for k, key in enumerate(keys.tolist()):
        tumor = SampleData(
            genotype=fl["tumor_gt"][k],
            joint_genotype=fl["joint_tumor_gt"][k],
            joint_consensus_quality=fl["joint_cnsq"][k],
            consensus_quality=fl["tumor_cnsq"][k],
            variant_allele_quality=fl["tumor_vaq"][k],
            somatic_score=fl["somatic_score"][k],
            variant_status=fl["tumor_status"][k],
            dqstats=dq_t[k],
        )
        normal = SampleData(
            genotype=fl["normal_gt"][k],
            joint_genotype=fl["joint_normal_gt"][k],
            joint_consensus_quality=fl["joint_cnsq"][k],
            consensus_quality=fl["normal_cnsq"][k],
            variant_allele_quality=fl["normal_vaq"][k],
            somatic_score=-1,
            variant_status=fl["normal_status"][k],
            dqstats=dq_n[k],
        )
        out.append((key, SniperRecord(
            seq_name=names_l[k], pos=poss_l[k], ref_base=chars_l[k],
            ref_base4=rb4_l[k], tumor=tumor, normal=normal)))
    return out
