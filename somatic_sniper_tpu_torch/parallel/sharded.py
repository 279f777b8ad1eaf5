"""Region-sharded streaming driver of the torch port.

Port of somatic_sniper_tpu/parallel/sharded.py:126-420.  The windowing,
shard split, contig-transition quirk carry and manifest are imported
from the JAX module (its module level is jax-free); the driver loop is
carried here because the JAX one imports its device pieces from
``somatic_sniper_tpu.runner``, which needs JAX.  Fast windows feed the
port's ``TorchSlabDispatcher``; exact windows are scored by the native
host layer.  The concatenation of all windows' lines is byte-identical
to the whole-file run.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Iterator

import numpy as np

from somatic_sniper_tpu.io import bai, native_api
from somatic_sniper_tpu.io.bam import read_bam_header
from somatic_sniper_tpu.io.fasta import FastaFile
from somatic_sniper_tpu.models.tables import ModelParams, build_tables
from somatic_sniper_tpu.parallel.sharded import (  # noqa: F401 (re-export)
    DEFAULT_WINDOW,
    Manifest,
    _QuirkCarry,
    genome_windows,
    shard_windows,
)
from somatic_sniper_tpu.pileup.prefilter import prefilter_tables
from somatic_sniper_tpu.utils.stats import STATS

from ..models.tables import device_tables
from ..runner import (
    NOT_PORTED,
    RefCache,
    _ref_blob,
    can_exact_native,
    can_plan,
    exact_records_native,
    make_plan,
    require_native,
)
from .slab import TorchSlabDispatcher


def call_pair_windows(
    tumor_bam: str,
    normal_bam: str,
    ref_fasta: str | None,
    fmt: str,
    params: ModelParams = ModelParams(),
    precision: str = "exact",
    window_size: int = DEFAULT_WINDOW,
    shards: int = 1,
    shard_index: int | None = None,
    skip_windows: set[int] | None = None,
    device=None,
) -> Iterator[tuple[int, tuple[int, int, int], list[str]]]:
    """Yield (window_index, window, output lines of ``fmt``) per genome
    window, in window order.  Window indices are global (stable across
    shard counts).  ``device`` scores the fast path's slabs."""
    require_native()
    if precision == "fast" and device is None:
        raise ValueError("fast precision needs a device")
    header = read_bam_header(tumor_bam)
    idx_t = bai.ensure_index(tumor_bam)
    idx_n = bai.ensure_index(normal_bam)
    windows = genome_windows(header.ref_lengths, window_size)
    mine = shard_windows(list(enumerate(windows)), shards, shard_index)

    fasta = FastaFile(ref_fasta) if ref_fasta else None
    refcache = RefCache(fasta, header)
    tabs = build_tables(params)
    ref_blob, ref_off = _ref_blob(fasta, header)
    packed16 = precision == "fast" and ref_blob is not None

    carry_t = _QuirkCarry(tumor_bam, idx_t, header,
                          params.flag_mask, params.mapq_threshold)
    carry_n = _QuirkCarry(normal_bam, idx_n, header,
                          params.flag_mask, params.mapq_threshold)

    flag_args = None
    if ref_blob is not None:
        pt = prefilter_tables(tabs)
        if pt is not None:
            gmin, margin = pt
            flag_args = (ref_blob, ref_off, tabs.fk, gmin, margin)

    def _load_one(path, idx, carry, tid, beg, end):
        return native_api.load_region_and_columnize(
            path, np.asarray(bai.region_chunks(idx, tid, beg, end)),
            tid, beg, end, params.flag_mask, params.mapq_threshold,
            n_threads=1, drop_first_end_le=carry.for_window(tid, beg),
            flag_args=flag_args,
        )

    todo = [(wi, w) for wi, w in mine
            if not (skip_windows and wi in skip_windows)]
    # region-load pool: cores minus the main and device threads, in
    # [2, 6] (sharded.py:220-234)
    pool_n = max(2, min(6, (os.cpu_count() or 2) - 2))
    ex = ThreadPoolExecutor(max_workers=pool_n)
    # with threads to spare beyond a window's two loads, the window's
    # plan rides the pool too (sharded.py:239-247)
    offload_plan = pool_n >= 3

    def _submit_window(win):
        """The window's two region loads, and on wide pools its plan
        chained behind them; resolves to (pu_t, pu_n, plan-or-None)
        (sharded.py:249-299)."""
        tid, beg, end = win
        f_t = ex.submit(_load_one, tumor_bam, idx_t, carry_t, tid, beg, end)
        f_n = ex.submit(_load_one, normal_bam, idx_n, carry_n, tid, beg,
                        end)
        done = Future()
        n_landed = [0]
        cb_lock = threading.Lock()

        def _plan_task():
            try:
                pu_t, pu_n = f_t.result(), f_n.result()
                plan = None
                if can_exact_native(pu_t, pu_n, ref_blob):
                    plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
                done.set_result((pu_t, pu_n, plan))
            except BaseException as e:  # surfaces on .result()
                done.set_exception(e)

        def _resolve_loads():
            try:
                done.set_result((f_t.result(), f_n.result(), None))
            except BaseException as e:
                done.set_exception(e)

        def _on_load(_):
            with cb_lock:
                n_landed[0] += 1
                if n_landed[0] < 2:
                    return
            if offload_plan:
                ex.submit(_plan_task)
            else:
                _resolve_loads()

        f_t.add_done_callback(_on_load)
        f_n.add_done_callback(_on_load)
        return done

    lookahead = 2 if pool_n <= 2 else (pool_n + 1) // 2 + 1
    inflight = [_submit_window(w) for _, w in todo[:lookahead]]

    slab_disp = None
    try:
        for i, (wi, (tid, beg, end)) in enumerate(todo):
            fut = inflight.pop(0)
            with STATS.timer("load_wait"):
                # drain landed slabs while the next loads run, so decode
                # and emit work fills what would be idle wait
                if slab_disp is not None:
                    while not fut.done():
                        slab_disp.poll()
                        yield from slab_disp.ready()
                        futures_wait([fut], timeout=0.02)
                pu_t, pu_n, plan = fut.result()
            j = i + lookahead
            if j < len(todo):
                inflight.append(_submit_window(todo[j][1]))
            win = (tid, beg, end)
            if precision == "exact":
                if not can_exact_native(pu_t, pu_n, ref_blob):
                    raise RuntimeError(
                        "exact precision needs native pileups and a "
                        "reference; the f64 glfgen fallback is "
                        + NOT_PORTED)
                lines = exact_records_native(
                    pu_t, pu_n, tabs, ref_blob, ref_off, refcache, fmt,
                    plan=plan,
                )
                yield wi, win, [ln for _, ln in lines]
                continue
            if not can_plan(pu_t, pu_n, packed16):
                raise RuntimeError(
                    "fast precision needs native pileups and a reference; "
                    "the non-plan batch path is " + NOT_PORTED)
            if slab_disp is None:
                slab_disp = TorchSlabDispatcher(
                    lambda: device_tables(tabs, device), tabs, params,
                    refcache, device, fmt,
                )
            if plan is None:
                plan = make_plan(pu_t, pu_n, tabs, ref_blob, ref_off)
            slab_disp.add_window(wi, win, pu_t, pu_n, plan,
                                 remaining=len(todo) - 1 - i)
            yield from slab_disp.ready()
        if slab_disp is not None:
            with STATS.timer("tail"):
                yield from slab_disp.finish()
    finally:
        ex.shutdown(wait=True)


def call_pair_sharded(*args, **kwargs) -> Iterator[str]:
    """Flattened line stream over :func:`call_pair_windows`."""
    for _, _, lines in call_pair_windows(*args, **kwargs):
        yield from lines
