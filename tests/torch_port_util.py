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


def pack_slab_meta(ref16, d_t, d_n, nk_t, nk_n, D: int):
    """The [3, B] int32 metadata of a packed slab of depth D in the
    layout of io.native_api.slab_fill_pair: depths and kept counts in
    bytes of row 2 to D = 255, in 16-bit halves of rows 1 (depths) and 2
    (kept counts) deeper."""
    d_t, d_n, nk_t, nk_n = (np.asarray(a, np.int64)
                            for a in (d_t, d_n, nk_t, nk_n))
    meta = np.zeros((3, len(d_t)), np.int64)
    meta[0] = np.asarray(ref16, np.int64) << 24
    if D <= 255:
        meta[2] = d_t | d_n << 8 | nk_t << 16 | nk_n << 24
    else:
        meta[1] = d_t | d_n << 16
        meta[2] = nk_t | nk_n << 16
    return meta.astype(np.uint32).view(np.int32)


def random_slab(B: int, D: int, seed: int):
    """A packed two-sample slab: (stacked uint32 [2, B, D], meta int32
    [3, B]) in the layout of io.native_api.slab_fill_pair."""
    s_t, nk_t, d_t, ref16 = random_raw32(B, D, seed)
    s_n, nk_n, d_n, _ = random_raw32(B, D, seed + 1000)
    stacked = np.stack([s_t, s_n])
    return stacked, pack_slab_meta(ref16, d_t, d_n, nk_t, nk_n, D)


def deep_raw32(B: int, D: int, seed: int):
    """Raw kept-only lanes of one sample, every column 256-D reads deep:
    the first half drawn like the kernel tests (every base code, zero
    base qualities, every mapQ), the second half built to give
    likelihoods strictly between 0 and 255: base qualities 2-9, mapQ 60,
    the reads split between the reference base and one other.  Returns
    (slots uint32 [B, D], n_keep int32 [B], ref16 int32 [B])."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(256, D + 1, B).astype(np.int32)
    ref16 = rng.choice([1, 2, 4, 8], size=B).astype(np.int32)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04]).astype(np.uint32)
    baseq = rng.integers(0, 94, (B, D)).astype(np.uint32)
    mapq = rng.integers(0, 256, (B, D)).astype(np.uint32)
    half = B // 2
    alt = np.roll(ref16, 1)[half:, None].astype(np.uint32)
    frac = rng.uniform(0.2, 0.8, (B - half, 1))
    base[half:] = np.where(rng.random((B - half, D)) < frac, alt,
                           ref16[half:, None].astype(np.uint32))
    baseq[half:] = rng.integers(2, 10, (B - half, D))
    mapq[half:] = 60
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    words = mapq | (baseq << 8) | (base << 16) | (strand << 20)
    slots = np.where(np.arange(D)[None, :] < nk[:, None], words, 0)
    return slots.astype(np.uint32), nk, ref16


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


SCORE_PAD = 5  # padding columns at the end of a score_inputs batch


def score_inputs(B: int, D: int, seed: int, hi: int):
    """The inputs of ``ops.score_kernels.score_columns`` for B columns:
    ({"tumor": ..., "normal": ...} of numpy arrays ``lk`` [B, 10] in
    [0, hi) (a small hi forces ties in every scan), raw kept-only
    ``slots`` uint32 [B, D] with their ``nk``, the raw ``depth`` and
    glfgen's count ``n`` (= nk), and ``ref16`` [B]).  Where B >= 16 the
    first rows tie by construction (all equal; two and three equal
    minima), columns 4, 5 and 6 hold n_keep 0, 1 and D, ref16 is 15 on
    column 7 and 0 on column 8, and the last SCORE_PAD columns are
    padding (everything 0, as the batch path pads)."""
    rng = np.random.default_rng(seed)
    special = B >= 16
    out = {}
    ref16 = None
    for i, who in enumerate(("tumor", "normal")):
        slots, nk, depth, r = random_raw32(B, D, seed + 1000 * i)
        ref16 = r if ref16 is None else ref16
        lk = rng.integers(0, hi, (B, 10)).astype(np.int32)
        if special:
            lk[0] = 0
            lk[1] = 7
            lk[2] = [9, 3, 9, 3, 9, 9, 3, 9, 9, 9]
            lk[3] = [4, 4, 1, 1, 4, 4, 4, 1, 4, 4]
            # D fresh kept words on column 6 (bits below 21: no deletion)
            slots[4] = 0
            slots[5, 1:] = 0
            slots[6] = rng.integers(0, 1 << 21, D).astype(np.uint32)
            nk[4], nk[5], nk[6] = 0, 1, D
            depth[4], depth[5], depth[6] = 0, 1, D
        n = nk.copy()
        if special:
            slots[-SCORE_PAD:], nk[-SCORE_PAD:], depth[-SCORE_PAD:] = 0, 0, 0
            lk[-SCORE_PAD:], n[-SCORE_PAD:] = 0, 0
        out[who] = dict(slots=slots, nk=nk, depth=depth, lk=lk, n=n)
    ref16 = ref16.copy()
    if special:
        ref16[7], ref16[8] = 15, 0
        ref16[-SCORE_PAD:] = 0
    return out, ref16


def eager_stand_in(step, stream, pool):
    """The eager step in place of a CUDA graph (models/step_graph's
    ``capture`` on the CPU): its outputs, and a replay that scores the
    static inputs again into them, counting no launch (a graph's replay
    runs no wrapper)."""
    from somatic_sniper_tpu_torch.ops import glfgen_kernels as gk

    out = step()

    def replay():
        before = dict(gk.LAUNCHES)
        new = step()
        gk.LAUNCHES.update(before)
        for fixed, t in zip(out, new):
            fixed.copy_(t)

    return out, replay


# the phred fields the fast contract lets differ by one from the JAX
# package's (f32 class sums)
PM1 = ("tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq",
       "somatic_score", "joint_cnsq")


def paired_batch(b0: int, D: int, seed: int, packed16: bool):
    """A PairedBatch of the batch path's upload layout (``random_stacked``
    as ``runner.submit_call_batch`` takes it), its ref16, and its upload
    (stacked, meta) padded to ``runner._b_bucket(b0)`` as the runner
    pads it."""
    from somatic_sniper_tpu_torch import runner
    from somatic_sniper_tpu_torch.pileup.columnize import PairedBatch

    stacked, meta = random_stacked(b0, D, seed, packed16)
    extra = (dict(nk_tumor=meta[3], nk_normal=meta[4], rms_tumor=meta[5],
                  rms_normal=meta[6]) if packed16 else {})
    batch = PairedBatch(keys=np.arange(b0, dtype=np.int64), ref16=meta[2],
                        tumor=stacked[0], normal=stacked[1], n_tumor=meta[0],
                        n_normal=meta[1], **extra)
    B = runner._b_bucket(b0)
    padded = (np.stack([runner._pad_b(x, B) for x in stacked]),
              np.stack([runner._pad_b(x, B) for x in meta]))
    return batch, meta[2], padded


def held_to_jax(rows, rows_w, exact: bool) -> None:
    """The port's emitted rows [n, 1 + fields (+ 36)] against the JAX
    package's on the same inputs: exact precision every row equal; fast
    the calls equal, the phred fields within +/-1 and 99% of the rows
    equal (the fast contract)."""
    from somatic_sniper_tpu_torch.models.fields import COMPACT_FIELDS

    rows_w = np.asarray(rows_w).astype(int)
    if exact:
        np.testing.assert_array_equal(rows, rows_w)
        return
    pm1 = [1 + COMPACT_FIELDS.index(f) for f in PM1]
    same = [j for j in range(rows.shape[1]) if j not in pm1]
    np.testing.assert_array_equal(rows[:, same], rows_w[:, same])
    d = np.abs(rows.astype(int) - rows_w)
    assert d.max(initial=0) <= 1
    assert len(d) == 0 or (d == 0).all(axis=1).mean() >= 0.99


def jax_call_batch_stacked(padded, packed16: bool, precision: str, jparams):
    """The JAX package's jitted ``call_batch_stacked`` on a padded upload
    (``paired_batch``), compact with K = min(B, 16384), XLA backend."""
    import jax.numpy as jnp

    from somatic_sniper_tpu.models import somatic as js
    from somatic_sniper_tpu.models import tables as JT

    tabs = JT.build_tables(jparams)
    fk, coef, lhet = (f32_tables(tabs) if precision == "fast"
                      else (tabs.fk, tabs.coef, tabs.lhet))
    B = padded[0].shape[1]
    return js.call_batch_stacked(
        jnp.asarray(padded[0]), jnp.asarray(padded[1]), fk, coef, lhet,
        tabs.solo_prior, tabs.joint_prior, tabs.qadd, tabs.q_r_int,
        precision=precision, use_joint=jparams.use_joint_priors,
        min_somatic_qual=jparams.min_somatic_qual,
        cap_mapq=jparams.cap_mapq, theta=jparams.theta, eta=jparams.eta,
        max_emit=min(B, 16384), glf_backend="xla", packed16=packed16)
