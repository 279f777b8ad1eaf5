"""Shared inputs for the torch-port parity tests (tests/test_torch_*.py).

Inputs are made from numpy seeds and handed to both the JAX package and
the port as numpy arrays, so both sides see the same bits.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

FILTER = re.compile(r"##fileDate|##reference=")


def filtered_lines(path: Path) -> list[str]:
    """Output lines without the run-dependent VCF header lines."""
    return [ln for ln in Path(path).read_text().splitlines()
            if not FILTER.search(ln)]


def random_raw32(B: int, D: int, seed: int, p_del: float = 0.05):
    """Random raw kept-only slab lanes of one sample.

    Draws full slot words the way tests/test_pallas.py does (ambiguous
    and '=' bases, zero base qualities, every mapQ), drops the deletion
    entries and left-packs the kept ones, as the native slab fill does.
    Returns (slots uint32 [B, D], n_keep int32 [B], depth int32 [B],
    ref16 int32 [B]); ``depth`` counts the dropped deletions too."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, D + 1, B).astype(np.int32)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = np.where(rng.random((B, D)) < 0.05, 0,
                     rng.integers(0, 94, (B, D))).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    is_del = rng.random((B, D)) < p_del
    words = mapq | (baseq << 8) | (base << 16) | (strand << 20)
    keep = (np.arange(D)[None, :] < depth[:, None]) & ~is_del
    order = np.argsort(~keep, axis=1, kind="stable")  # kept lanes first
    slots = np.take_along_axis(np.where(keep, words, 0), order, axis=1)
    n_keep = keep.sum(axis=1).astype(np.int32)
    ref16 = rng.choice([1, 2, 4, 8, 15], size=B).astype(np.int32)
    return slots.astype(np.uint32), n_keep, depth, ref16


def random_slab(B: int, D: int, seed: int):
    """A packed two-sample slab: (stacked uint32 [2, B, D], meta int32
    [3, B]) in the layout of io.native_api.slab_fill_pair."""
    s_t, nk_t, d_t, ref16 = random_raw32(B, D, seed)
    s_n, nk_n, d_n, _ = random_raw32(B, D, seed + 1000)
    stacked = np.stack([s_t, s_n])
    meta = np.zeros((3, B), np.int64)
    meta[0] = ref16.astype(np.int64) << 24
    meta[2] = (d_t.astype(np.int64) | d_n.astype(np.int64) << 8
               | nk_t.astype(np.int64) << 16 | nk_n.astype(np.int64) << 24)
    return stacked, meta.astype(np.uint32).view(np.int32)


def f32_tables(tabs):
    """The fast path's f32 model tables (what both packages put on the
    device)."""
    return (tabs.fk.astype(np.float32), tabs.coef.astype(np.float32),
            tabs.lhet.astype(np.float32))
