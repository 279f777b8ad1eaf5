"""Single-host calling driver of the torch port: BAM pair -> output lines.

The host helpers below are jax-free copies of somatic_sniper_tpu/runner.py
(the port imports nothing of the JAX package); each names its source
lines.  The device path
is the port's: ``TorchSlabDispatcher`` and the batch path
(``submit_batches`` / ``collect_pending``) over ``models.somatic``.

Exact precision runs entirely in the native host layer, as in the JAX
package.  Fast precision with native pileups and a reference plans
natively, then scores the survivors on the device in uniform slabs;
columns deeper than the slab depth are scored exactly on the host.
Fast precision without them (no native library: pure-Python decode and
columnize; no reference) takes the batch path: every shared column,
bucketed by depth, is scored on the device in u16 batches (with a
reference) or full-u32 batches (without one).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch

from .constants import NT16_TABLE
from .io import native_api
from .io.bam import BamHeader, read_bam, read_bam_header
from .io.fasta import FastaFile
from .models.somatic import COMPACT_FIELDS, CallResult, call_batch_stacked
from .models.tables import (DeviceTables, ModelParams, build_tables,
                            device_tables)
from .output.dqstats import get_dqstats_rows
from .pileup.columnize import (DEPTH_BUCKETS, PairedBatch, columnize,
                               paired_batches, split_key)
from .pileup.prefilter import build_ref16, prefilter_tables, pure_flags
from .utils.stats import STATS

NOT_PORTED = "not yet in the torch port"
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
    """Raise unless the native host library loads: exact precision (its
    f64 glfgen fallback is not ported) and the windowed driver's region
    loads need it."""
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


def device_min_cols() -> int:
    """Survivor count below which fast runs score on the host instead
    of dispatching: ``SNIPER_DEVICE_MIN_COLS``, else 0.

    The JAX package derives its default from a probed link round trip
    (runner.py:452-514), because its accelerator sat behind a remote
    link; a card on the host's PCIe has no such latency to hide, so
    the port always dispatches unless told otherwise."""
    env = os.environ.get("SNIPER_DEVICE_MIN_COLS")
    if env is not None:
        try:
            return int(env)
        except ValueError:
            pass
    return 0


def make_plan(pu_t, pu_n, tabs, ref_blob, ref_off):
    """One native ``paired_plan`` pass (runner.py:555-584): ukey
    intersection, the pure-reference prefilter, the proof-only
    dual-consensus gate (unresolved columns go on to full scoring, which
    applies the whole gate) and depth grouping."""
    pt = prefilter_tables(tabs)
    gmin, margin = pt if pt is not None else (None, 0.0)
    with STATS.timer("plan"):
        plan = native_api.paired_plan(
            pu_t, pu_n, ref_blob, ref_off, DEPTH_BUCKETS, fk=tabs.fk,
            gmin=gmin, margin=margin, coef=tabs.coef, lhet=tabs.lhet,
            q_r_int=tabs.q_r_int, cns_mode="proof")
    STATS.add("columns_scored", len(plan.keys))
    return plan


def exact_records_native(pu_t, pu_n, tabs, ref_blob, ref_off, refcache,
                         fmt: str, plan=None) -> list[tuple[int, str]]:
    """Exact mode entirely in the native layer: plan, then full f64 and
    integer scoring of every survivor (runner.py:517-552).  Returns
    (column key, output line) pairs in coordinate order."""
    if plan is None:
        plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
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
    fmt: str,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    device=None,
) -> Iterator[str]:
    """Whole-file run (runner.py:286-398), yielding the output lines of
    ``fmt`` ("classic"/"vcf"/"bed") in coordinate order.  ``device`` (a
    torch.device) scores the fast path's slabs or batches; exact
    precision never touches it."""
    if precision == "exact":
        require_native("exact precision (the f64 glfgen is "
                       f"{NOT_PORTED})")
    elif device is None:
        raise ValueError("fast precision needs a device")
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
            pt = prefilter_tables(tabs)
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
    if precision == "exact":
        if not can_exact_native(pu_t, pu_n, ref_blob):
            raise RuntimeError(
                "exact precision needs native pileups and a reference; "
                "the f64 glfgen fallback is " + NOT_PORTED)
        for _, line in exact_records_native(
                pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt):
            yield line
        return
    # u16 batches carry '=' resolved against the reference; without
    # one the batch path ships full u32 slots
    packed16 = ref_blob is not None
    if not can_plan(pu_t, pu_n, packed16):
        dtabs = device_tables(tabs, device)
        drop_t, drop_n = _prefilter_flags(pu_t, pu_n, ref_blob, ref_off,
                                          tabs)
        ref16_fn = _make_ref16_fn(ref_blob, ref_off) if packed16 else None
        pending = submit_batches(pu_t, pu_n, refcache, dtabs, device,
                                 drop_t, drop_n, packed16, ref16_fn,
                                 params.cap_mapq)
        for _, line in collect_pending(pending, pu_t, pu_n, refcache,
                                       dtabs, device, fmt):
            yield line
        return
    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
    if len(plan.keys) < device_min_cols():
        for _, line in exact_records_native(
                pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt,
                plan=plan):
            yield line
        return
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


def submit_call_batch(batch: PairedBatch, ref16: np.ndarray,
                      dtabs: DeviceTables, device, compact: bool = True):
    """Upload one batch and score it on ``device`` (runner.py:750-812,
    one device): one stacked upload of the two slot arrays (u16 stays
    u16, half the bytes) and one of the metadata rows.  Returns the
    on-device CompactResult (i32 rows, K = min(MAX_EMIT, B)) when
    ``compact``, else the full CallResult.  The JAX package padded the
    batch axis to a few bucket sizes (``_b_bucket``, :737-747) only to
    bound XLA recompiles; torch needs no such padding, and padded rows
    were empty and changed no output."""
    B = len(batch.keys)
    stacked_h = np.stack([batch.tumor, batch.normal])
    meta_rows = [batch.n_tumor, batch.n_normal, ref16]
    if batch.packed16:
        meta_rows += [batch.nk_tumor, batch.nk_normal, batch.rms_tumor,
                      batch.rms_normal]
    else:
        stacked_h = stacked_h.view(np.int32)
    meta_h = np.stack([np.asarray(r, np.int32) for r in meta_rows])
    with STATS.timer("device.upload"):
        stacked = torch.from_numpy(stacked_h).to(device)
        meta = torch.from_numpy(meta_h).to(device)
    STATS.add("device_columns", B)
    with STATS.timer("device.score"):
        return call_batch_stacked(stacked, meta, dtabs, dtabs.params,
                                  packed16=batch.packed16, compact=compact,
                                  max_emit=MAX_EMIT)


def submit_batches(pu_t, pu_n, refcache, dtabs, device, drop_t, drop_n,
                   packed16, ref16_fn, cap_mapq,
                   max_batch: int = MAX_BATCH) -> list:
    """Score every paired batch on the device (runner.py:399-418);
    returns the pending list for collect_pending, which fetches the
    rows.  Only counts and rows wait for the device: the kernels queue
    on its stream, but each assembly10 call reads its error word, so a
    batch's scoring ends inside its submit."""
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
        res = submit_call_batch(batch, ref16, dtabs, device)
        STATS.add("batches_dispatched", 1)
        STATS.add(f"batch_columns_at_depth_{batch.tumor.shape[1]}",
                  len(batch.keys))
        pending.append((batch, ref16, res))
    return pending


def collect_pending(pending, pu_t, pu_n, refcache, dtabs, device,
                    fmt: str) -> list[tuple[int, str]]:
    """Fetch the compacted results and build the output lines, sorted by
    column key (runner.py:624-698).  The counts come home in one copy,
    then each batch's first ``count`` rows (torch slices them exactly,
    so the JAX package's power-of-two fetch buckets, ``_emit_bucket``
    :727-734, are not needed).  A batch that emitted more rows than its
    compact result holds is scored again in full and emitted from the
    CallResult."""
    records: list[tuple[int, str]] = []
    if not pending:
        return records
    with STATS.timer("device"):
        counts = torch.stack([p[2].count for p in pending]).cpu().tolist()
    for (batch, ref16, res), count in zip(pending, counts):
        if count <= 0:
            continue
        if count > res.rows.shape[0]:
            full = submit_call_batch(batch, ref16, dtabs, device,
                                     compact=False)
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
                 fmt: str) -> list[tuple[int, str]]:
    """(column key, output line) pairs of the emitted columns of a full
    CallResult (runner.py:822-838), through emit_records_compact."""
    idx = np.nonzero(res.emit.cpu().numpy())[0]
    if len(idx) == 0:
        return []
    fields = [getattr(res, f).cpu().numpy()[idx] for f in COMPACT_FIELDS]
    rows = np.stack([idx, *fields], axis=1).astype(np.int64)
    return emit_records_compact(keys, rows, ref16, pu_t, pu_n, refcache,
                                fmt)


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
                         fmt: str) -> list[tuple[int, str]]:
    """(column key, output line) pairs from an emitted-row matrix
    [count, 1 + NF (+ 36)] (runner.py:841-932): leading column the index
    into ``keys``/``ref16``, then the COMPACT_FIELDS, then (when present)
    the tumor and normal dqstats the device computed; without them the
    host walks the pileups."""
    if len(rows) == 0:
        return []
    idx = rows[:, 0].astype(np.int64)
    nf = len(COMPACT_FIELDS)
    keys = keys[idx]
    tids = (keys >> 40).astype(np.int64)
    poss = (keys & ((1 << 40) - 1)).astype(np.int64)
    chars = _ref_chars_for(keys, refcache)
    rb4 = ref16[idx].astype(np.int64)
    f = {name: rows[:, 1 + j] for j, name in enumerate(COMPACT_FIELDS)}
    if rows.shape[1] == 1 + nf + 36:
        rows_t = rows[:, 1 + nf:1 + nf + 18]
        rows_n = rows[:, 1 + nf + 18:1 + nf + 36]
    else:
        wanted = rb4 | f["tumor_eff_gt"] | f["normal_eff_gt"]
        with STATS.timer("emit.dqstats"):
            rows_t = get_dqstats_rows(pu_t, np.searchsorted(pu_t.ukeys, keys),
                                      rb4, wanted)
            rows_n = get_dqstats_rows(pu_n, np.searchsorted(pu_n.ukeys, keys),
                                      rb4, wanted)
    names = refcache.header.ref_names
    fields = np.stack(
        [np.asarray(f[k], np.int64) for k in COMPACT_FIELDS[:12]], axis=1)
    lines = native_api.emit_lines(fmt, names, tids, poss, chars, rb4, fields,
                                  rows_t, rows_n)
    if lines is None:  # non-ASCII reference names: the Python builders
        from .output.fast_emit import LINE_BUILDERS

        fl = {k: np.asarray(v).tolist() for k, v in f.items()}
        lines = LINE_BUILDERS[fmt](
            [names[t] for t in tids.tolist()], poss.tolist(),
            chars.tolist(), rb4.tolist(), fl, rows_t.tolist(),
            rows_n.tolist(),
        )
    return list(zip(keys.tolist(), lines))
