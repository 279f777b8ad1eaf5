"""Uniform-slab dispatch onto a torch device.

``TorchSlabDispatcher`` keeps all of the JAX package's slab logic
(somatic_sniper_tpu/parallel/slab.py:171-699: depth choice, cross-window
filling, host scoring of deep columns, in-order window release) and
replaces only the device interaction: each full slab is uploaded on a
dedicated CUDA stream, scored by ``models.somatic.call_batch_packed``,
and its u8 rows come back after one ``stream.synchronize()``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from somatic_sniper_tpu.output.dqstats import get_dqstats_rows
from somatic_sniper_tpu.parallel.slab import SlabDispatcher
from somatic_sniper_tpu.utils.stats import STATS

from ..models.somatic import COMPACT_FIELDS, call_batch_packed


class TorchSlabDispatcher(SlabDispatcher):
    """SlabDispatcher whose slabs are scored on ``device``.

    ``dtabs_fn`` returns the port's DeviceTables for ``device``; windows
    come out as (window index, window, output lines of ``fmt``)."""

    def __init__(self, dtabs_fn, tabs, params, refcache, device, fmt: str):
        super().__init__(dtabs_fn, tabs, params, refcache, fmt=fmt)
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _dispatch_and_fetch(self, stacked_h, meta_h):
        """Upload one slab, score it, return ``(count, rows[:count])``
        as numpy (runs on the background device thread; the host
        buffers are owned by the caller and never reused)."""
        dtabs = self.dtabs_fn()
        STATS.add(f"slabs_at_depth_{stacked_h.shape[2]}", 1)
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            if self._stream is not None:
                # the tables were uploaded on the default stream
                self._stream.wait_stream(
                    torch.cuda.default_stream(self.device))
            with STATS.timer("pad+dispatch.upload"):
                stacked = torch.from_numpy(stacked_h.view(np.int32)).to(
                    self.device)
                meta = torch.from_numpy(meta_h).to(self.device)
            res = call_batch_packed(stacked, meta, dtabs, self.params)
            count = res.count.to("cpu")
            rows = res.rows.to("cpu")
            if self._stream is not None:
                self._stream.synchronize()
        n = int(count)
        return n, rows[:n].numpy()

    def _tail_break_even(self, count: int) -> int:
        """Fixed threshold (runner.device_min_cols, 0 by default): the
        run's end is dispatched like any other slab."""
        from ..runner import device_min_cols

        return max(0, device_min_cols())

    def _widen_with_dq(self, pu_t, pu_n, ti, ni, ref16, rows):
        """Append the 36 host-computed dqstats columns to exact host rows
        (slab.py:411-429), in the port's COMPACT_FIELDS order."""
        idx = np.asarray(rows[:, 0], np.int64)
        rb4 = np.asarray(ref16, np.int64)[idx]
        teff = rows[:, 1 + COMPACT_FIELDS.index("tumor_eff_gt")]
        neff = rows[:, 1 + COMPACT_FIELDS.index("normal_eff_gt")]
        wanted = rb4 | teff | neff
        dq_t = get_dqstats_rows(pu_t, np.asarray(ti)[idx], rb4, wanted)
        dq_n = get_dqstats_rows(pu_n, np.asarray(ni)[idx], rb4, wanted)
        return np.concatenate(
            [rows, dq_t.astype(rows.dtype), dq_n.astype(rows.dtype)],
            axis=1,
        )

    def _emit_window(self, ws) -> None:
        """One merged emit over every staged result batch of a window
        (slab.py:598-625), through the port's record builder."""
        from ..runner import emit_records_compact

        with self._lock:
            pending, ws.pending = ws.pending, []
        if not pending:
            return
        base = 0
        keys_l, ref_l, rows_l = [], [], []
        for keys, ref16, rows in pending:
            r = np.asarray(rows, np.int64)
            r[:, 0] += base
            rows_l.append(r)
            keys_l.append(keys)
            ref_l.append(ref16)
            base += len(keys)
        with STATS.timer("emit"):
            recs = emit_records_compact(
                np.concatenate(keys_l), np.concatenate(rows_l),
                np.concatenate(ref_l), ws.pu_t, ws.pu_n, self.refcache,
                self.fmt,
            )
        ws.records.extend(recs)
