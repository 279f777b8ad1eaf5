"""Shared inputs for the torch-port parity tests (tests/test_torch_*.py).

Inputs are made from numpy seeds and handed to both the JAX package and
the port as numpy arrays, so both sides see the same bits.
"""

from __future__ import annotations

import dataclasses
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


def port_params(jparams):
    """The port's ModelParams with the fields of the JAX package's."""
    from somatic_sniper_tpu_torch.models.tables import ModelParams

    return ModelParams(**dataclasses.asdict(jparams))


def f32_tables(tabs):
    """The fast path's f32 model tables (what both packages put on the
    device)."""
    return (tabs.fk.astype(np.float32), tabs.coef.astype(np.float32),
            tabs.lhet.astype(np.float32))


def random_u32(B: int, D: int, seed: int, p_del: float = 0.05):
    """Random full u32 slot words of one sample, drawn as
    tests/test_pallas.py draws them: deletions stay among the lanes and
    the first ``depth[b]`` lanes of row b are occupied.  Returns
    (slots uint32 [B, D], depth int32 [B], ref16 int32 [B])."""
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, D + 1, B).astype(np.int32)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = np.where(rng.random((B, D)) < 0.05, 0,
                     rng.integers(0, 94, (B, D))).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    is_del = (rng.random((B, D)) < p_del).astype(np.uint32)
    words = (mapq | (baseq << 8) | (base << 16) | (strand << 20)
             | (is_del << 21))
    occupied = np.arange(D)[None, :] < depth[:, None]
    slots = np.where(occupied, words, 0).astype(np.uint32)
    ref16 = rng.choice([1, 2, 4, 8, 15], size=B).astype(np.int32)
    return slots, depth, ref16


def to_packed16(slots, depth, ref16, cap_mapq: int = 60):
    """Full u32 slot words -> compact u16 lanes, as tests/test_pallas.py
    _to_packed16 and the host's pad16 build them: deletions dropped,
    '=' resolved to the reference base, ambiguity codes in class A, eff
    floored, kept lanes left-packed.  Returns (slots16 uint16 [B, D],
    n_keep int32 [B], rms_sum int32 [B])."""
    B, D = slots.shape
    s = slots.astype(np.uint32)
    keep = ((np.arange(D)[None, :] < depth[:, None])
            & (((s >> 21) & 1) == 0))
    mq = (s & 0xFF).astype(np.int32)
    q = ((s >> 8) & 0xFF).astype(np.int32)
    b16 = ((s >> 16) & 0xF).astype(np.int32)
    code = np.where(b16 != 0, b16, ref16[:, None])
    base2 = np.select([code == 2, code == 4, code == 8], [1, 2, 3], 0)
    eff = np.minimum(q, mq)
    eff = np.where((eff < 4) & ((q & 0x3F) != 0), 4, eff)
    val = eff | (base2 << 8) | (((s >> 20) & 1).astype(np.int32) << 10)
    order = np.argsort(~keep, axis=1, kind="stable")
    out = np.take_along_axis(np.where(keep, val, 0), order, axis=1)
    m7 = np.minimum(mq & 0x7F, cap_mapq)
    rms = np.where(keep, m7 * m7, 0).sum(axis=1)
    return (out.astype(np.uint16), keep.sum(axis=1).astype(np.int32),
            rms.astype(np.int32))


def hazard_column():
    """One column where the floored-eff rank of the Pallas ``accumulate``
    differs from the reference's raw-eff rank: class A, forward strand,
    (baseQ, mapQ) = (64, 3), (1, 0), (30, 60), reference A.  Raw eff
    orders them 30, 3, 0; the floor raises the (1, 0) read's eff to 4,
    which would order them 30, 4, 3.  Returns (slots uint32 [1, 3],
    depth int32 [1], ref16 int32 [1])."""
    baseq = np.array([64, 1, 30], np.uint32)
    mapq = np.array([3, 0, 60], np.uint32)
    slots = (mapq | (baseq << 8) | (1 << 16)).astype(np.uint32)[None, :]
    return slots, np.array([3], np.int32), np.array([1], np.int32)


def random_stacked(B: int, D: int, seed: int, packed16: bool):
    """A two-sample batch in the batch path's upload layout (runner
    submit_call_batch): (stacked [2, B, D] uint32 or uint16, meta int32
    [3, B] = d_t, d_n, ref16, or [7, B] with nk_t, nk_n, rms_t, rms_n)."""
    s_t, d_t, ref16 = random_u32(B, D, seed)
    s_n, d_n, _ = random_u32(B, D, seed + 1000)
    if not packed16:
        return np.stack([s_t, s_n]), np.stack([d_t, d_n, ref16])
    t16, nk_t, rms_t = to_packed16(s_t, d_t, ref16)
    n16, nk_n, rms_n = to_packed16(s_n, d_n, ref16)
    meta = np.stack([d_t, d_n, ref16, nk_t, nk_n, rms_t, rms_n])
    return np.stack([t16, n16]), meta.astype(np.int32)
