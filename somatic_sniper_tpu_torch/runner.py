"""Single-host calling driver of the torch port: BAM pair -> output lines.

The host helpers below are jax-free copies of somatic_sniper_tpu/runner.py
(that module imports jax at module level, so none of it can be imported
on a machine without JAX); each names its source lines.  The device path
is the port's: ``TorchSlabDispatcher`` over ``models.somatic``.

Exact precision runs entirely in the native host layer, as in the JAX
package.  Fast precision plans natively, then scores the survivors on
the device in uniform slabs; columns deeper than the slab depth are
scored exactly on the host.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from somatic_sniper_tpu.io import native_api
from somatic_sniper_tpu.io.bam import BamHeader, read_bam_header
from somatic_sniper_tpu.io.fasta import FastaFile
from somatic_sniper_tpu.models.tables import ModelParams, build_tables
from somatic_sniper_tpu.output.dqstats import get_dqstats_rows
from somatic_sniper_tpu.pileup.columnize import DEPTH_BUCKETS
from somatic_sniper_tpu.pileup.prefilter import build_ref16, prefilter_tables
from somatic_sniper_tpu.utils.stats import STATS

from .models.somatic import COMPACT_FIELDS
from .models.tables import device_tables

NOT_PORTED = "not yet in the torch port"


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


def require_native() -> None:
    """Both precisions of the port need the native host layer (the
    non-native batch path and the f64 JAX glfgen are not ported)."""
    if not native_api.available():
        raise RuntimeError(
            "the native host library (somatic_sniper_tpu/io/native) is "
            "unavailable; the pure-Python fallback is " + NOT_PORTED)


def _load_pileups(tumor_bam, normal_bam, params, flag_args=None):
    """Decode + columnize both BAMs natively, one OS thread per file
    (runner.py:203-230, native branch)."""
    from concurrent.futures import ThreadPoolExecutor

    require_native()
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
    """Whole-file run (runner.py:286-398, exact and fast branches),
    yielding the output lines of ``fmt`` ("classic"/"vcf"/"bed") in
    coordinate order.  ``device`` (a torch.device) scores the fast
    path's slabs; exact precision never touches it."""
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
    if not can_plan(pu_t, pu_n, ref_blob is not None):
        raise RuntimeError(
            "fast precision needs native pileups and a reference; the "
            "non-plan batch path is " + NOT_PORTED)
    if device is None:
        raise ValueError("fast precision needs a device")
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
        from somatic_sniper_tpu.output.fast_emit import LINE_BUILDERS

        fl = {k: np.asarray(v).tolist() for k, v in f.items()}
        lines = LINE_BUILDERS[fmt](
            [names[t] for t in tids.tolist()], poss.tolist(),
            chars.tolist(), rb4.tolist(), fl, rows_t.tolist(),
            rows_n.tolist(),
        )
    return list(zip(keys.tolist(), lines))
