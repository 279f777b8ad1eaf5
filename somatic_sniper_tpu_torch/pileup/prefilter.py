"""Pure-reference column prefilter (host-side throughput optimization).

The caller's emit gate requires the two samples' consensus genotypes to
differ (reference somatic_sniper.c:156).  For a column whose every
non-deleted entry carries the reference base, the MAQ model provably
calls the hom-ref genotype in that sample whenever a conservative margin
condition holds (see below), so a column that is pure in *both* samples
can never be emitted and need not be scored on the device at all.  On
30x data with ~0.5-1% base error this removes 60-75% of shared columns
from the device path — uploads, kernel batches, and result transfers all
shrink proportionally while output stays bit-identical.

Safety argument (all references to sniper_maqcns.c):

* hom-ref: tmp2 = 0 (all counting reads are ref-class), so
  ``p[ref,ref] = 0`` exactly (:188-196 via the tmp2>0 guard).
* het(ref, X): tmp1 = tmp2 = 0, so ``p = -4.343*lhet[c_ref, 0]`` which
  quantizes to lk >= 0; glf2cns adds the het penalty q_r (:250-273), so
  its t-value is >= q_r >= 1 whenever q_r_int >= 1.
* hom(X != ref) and het(X, Y) with X,Y != ref: tmp2 = c_tot = m, so
  ``p = esum_ref + coef[bar_e, m, m] (+ -4.343*lhet[0,0] = 0)``.  With
  ``L = sum_r fk[r] * effq_r`` accumulated in arrival order (a lower
  bound on esum_ref by the rearrangement inequality — the true
  per-class, quality-descending ranks only increase fk weights) and
  ``gmin[m] = min_q coef[q, m, m]``, the condition ``L + gmin[m] >=
  margin`` with margin >= 0.5 forces p >= 0.5, which quantizes to
  lk >= 1 (:236-243).

Hence hom-ref is the unique t-minimum in both samples, both consensus
calls equal the reference genotype, and the SNP gate fails.  Columns
that do not satisfy the margin (pathological all-low-quality pileups)
are simply left unfiltered.  The filter is disabled entirely when
q_r_int < 1 (het rate > ~0.37).

Copy of somatic_sniper_tpu/pileup/prefilter.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..constants import NT16_TABLE
from ..models.tables import ModelTables
from .columnize import ColumnarPileup

# p >= 0.5 is the mathematical requirement; the extra slack absorbs the
# float32 accumulation noise of the device's fast path (|err| << 1e-2).
MARGIN = 2.0


def prefilter_tables(tabs: ModelTables) -> tuple[np.ndarray, float] | None:
    """(gmin[256], margin) for the native/numpy filter, or None if the
    model parameters make the filter unsafe (q_r_int < 1)."""
    if tabs.q_r_int < 1:
        return None
    m = np.arange(256)
    gmin = tabs.coef[4:64, m, m].min(axis=0)  # [256]
    # het(X,Y) genotypes add -4.343*lhet[0,0] on top of the hom-other
    # bound; fold any positive excursion of that term into the margin.
    extra = max(0.0, 4.343 * float(tabs.lhet[0, 0]))
    return np.ascontiguousarray(gmin, np.float64), MARGIN + extra


def build_ref16(ref_seqs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate per-contig reference bytes into one 4-bit code blob.

    Returns (ref16 uint8[total], ref_off int64[n_ref + 1]).
    """
    ref_off = np.zeros(len(ref_seqs) + 1, np.int64)
    for i, s in enumerate(ref_seqs):
        ref_off[i + 1] = ref_off[i] + len(s)
    blob = np.empty(int(ref_off[-1]), np.uint8)
    for i, s in enumerate(ref_seqs):
        arr = np.frombuffer(s, np.uint8)
        blob[int(ref_off[i]) : int(ref_off[i + 1])] = NT16_TABLE[arr]
    return blob, ref_off


def pure_flags(
    pu: ColumnarPileup,
    ref16: np.ndarray,
    ref_off: np.ndarray,
    fk: np.ndarray,
    gmin: np.ndarray,
    margin: float,
) -> np.ndarray:
    """uint8[n_cols] filterable flags; native when available."""
    from ..io import native, native_api

    lib = native.get_lib()
    if lib is not None and getattr(pu.owner, "_ptr", None) is not None:
        out = np.empty(len(pu.ukeys), np.uint8)
        fkc = np.ascontiguousarray(fk, np.float64)
        gmc = np.ascontiguousarray(gmin, np.float64)
        r16 = np.ascontiguousarray(ref16, np.uint8)
        roff = np.ascontiguousarray(ref_off, np.int64)
        lib.pileup_flags(
            pu.owner._ptr,
            r16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            roff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ref_off) - 1,
            fkc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            gmc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(margin),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out
    return pure_flags_np(pu, ref16, ref_off, fk, gmin, margin)


def pure_flags_np(
    pu: ColumnarPileup,
    ref16: np.ndarray,
    ref_off: np.ndarray,
    fk: np.ndarray,
    gmin: np.ndarray,
    margin: float,
) -> np.ndarray:
    """Vectorized numpy fallback, value-identical to the native pass."""
    n_cols = len(pu.ukeys)
    if n_cols == 0:
        return np.zeros(0, np.uint8)
    depths = pu.depths
    tid = (pu.ukeys >> 40).astype(np.int64)
    pos = (pu.ukeys & ((1 << 40) - 1)).astype(np.int64)
    n_ref = len(ref_off) - 1
    tid_ok = (tid >= 0) & (tid < n_ref)
    tid_c = np.clip(tid, 0, max(n_ref - 1, 0))
    lens = np.diff(ref_off)
    pos_ok = tid_ok & (pos < lens[tid_c])
    addr = ref_off[tid_c] + np.minimum(pos, np.maximum(lens[tid_c] - 1, 0))
    rcode = np.where(pos_ok, ref16[addr], 0).astype(np.uint32)
    ref_valid = np.isin(rcode, (1, 2, 4, 8)) & pos_ok

    col_of = np.repeat(np.arange(n_cols, dtype=np.int64), depths)
    s = pu.slots.astype(np.uint32)
    is_del = ((s >> 21) & 1).astype(bool)
    b16 = (s >> 16) & 0xF
    rc_e = rcode[col_of]
    pure_e = is_del | (b16 == rc_e) | (b16 == 0)
    pure = (
        np.bitwise_and.reduceat(pure_e.view(np.uint8), pu.offsets[:-1])
        .astype(bool)
    )

    q = (s >> 8) & 0xFF
    mq = s & 0xFF
    eff = np.minimum(q, mq)
    eff = np.where((eff < 4) & ((q & 0x3F) != 0), 4, eff)
    counting = (~is_del) & (eff > 0)
    # arrival-order rank among counting entries within each column
    cs = np.cumsum(counting)
    start = np.concatenate(([0], cs[pu.offsets[1:-1] - 1])) if n_cols > 1 \
        else np.zeros(1, np.int64)
    rank = (cs - counting) - start[col_of]
    contrib = np.where(
        counting, fk[np.minimum(rank, 255)] * eff.astype(np.float64), 0.0
    )
    L = np.add.reduceat(
        np.concatenate((contrib, [0.0])), pu.offsets[:-1]
    )[:n_cols]
    L = np.where(depths > 0, L, 0.0)
    m = np.add.reduceat(
        np.concatenate((counting, [False])).astype(np.int64), pu.offsets[:-1]
    )[:n_cols]
    m = np.where(depths > 0, m, 0)

    ok = (
        ref_valid
        & pure
        & (m >= 1)
        & (L + gmin[np.where(m <= 255, m, 254)] >= margin)
        & (depths > 0)
    )
    return ok.astype(np.uint8)
