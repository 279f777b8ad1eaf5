"""Batched MAQ genotype likelihoods (glfgen), in both precisions.

Port of somatic_sniper_tpu/models/glfgen.py.  Fast precision (:53-85,
:453-527, :528-586) is f32: an accumulate (rank-weighted class sums)
then the assembly (ten-genotype likelihoods), hand-written CUDA kernels
on the card with plain torch versions on the CPU.  The kernel follows
the batch's slot encoding, and to depth 255 the two steps are one launch:

* raw kept-only int32 lanes with ``n_keep`` -> ``glfgen32``
  (``accumulate`` with ``n_keep`` as the depth above 255: a slab of a
  deep tier, ``parallel/slab.ALLOWED_D``; kept-only lanes hold no
  deletion, so it counts what ``accumulate32`` would);
* compact u16 lanes with ``n_keep`` and ``rms_sum`` -> ``glfgen16``
  (``accumulate16``);
* full u32 slot words with ``depth`` -> ``glfgen_u32`` (``accumulate``).

Batches and slabs deeper than 255 take the accumulate alone, rescale
their class counts (reference sniper_maqcns.c:178-182) and run
``assembly10`` with the full tables; its error word (a count outside
the tables) is left on the device in ``GlfResult.err`` for the caller to
read with the step's results, so the step never waits.

Exact precision (:105-198, :441-451, :579-756 with ``acc_f`` float64)
replicates the reference's mixed float/double arithmetic bit for bit in
torch ops, on whichever device the batch lies (the JAX package runs no
Pallas kernel here either: a sort and a scan).  It reads full u32 slot
words only.  The native host scorer covers exact runs whenever it can;
this path serves the ones it cannot (no native library, no reference).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.glfgen_kernels import (MAX_D, accumulate, accumulate16,
                                  assembly10_flagged, glfgen16, glfgen32,
                                  glfgen_u32)
from .tables import DeviceTables

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64

_TRIU = [(j, k) for j in range(4) for k in range(j, 4)]
_INVALID_KEY = 0xFFFFFFFF


class ColumnBatch(NamedTuple):
    """Pileup columns of one sample in one of three encodings.

    * Full u32 (``n_keep`` None): ``slots`` [B, D] int32 slot words
      ``mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21``, the
      first ``depth[b]`` lanes occupied, deletions among them.
    * Raw kept-only (``n_keep`` set, ``slots`` int32): the same words
      with the deletions filtered out (first ``n_keep[b]`` lanes
      occupied, is_del never set); ``depth`` still counts deletions.
    * Compact u16 (``n_keep`` and ``rms_sum`` set, ``slots`` uint16):
      ``effq | base2<<8 | strand<<10`` for the non-deleted reads, with
      the per-column rms sums ``sum min(mapQ & 0x7F, cap)^2`` from the
      host.

    ``depth`` is the raw column depth including deletions, which the
    consensus model needs."""

    slots: torch.Tensor                    # [B, D] int32 or uint16
    depth: torch.Tensor                    # [B] int32
    ref16: torch.Tensor                    # [B] int32
    n_keep: torch.Tensor | None = None     # [B] int32
    rms_sum: torch.Tensor | None = None    # [B] int32

    @property
    def encoding(self) -> str:
        """"u32", "raw32" or "u16"."""
        if self.n_keep is None:
            return "u32"
        if self.slots.dtype == torch.uint16:
            if self.rms_sum is None:
                raise ValueError("u16 lanes need the host's rms_sum")
            return "u16"
        return "raw32"


SLOT_BASEQ_SHIFT = 8
SLOT_BASE16_SHIFT = 16
SLOT_STRAND_SHIFT = 20
SLOT_ISDEL_SHIFT = 21


def pack_slots_np(base16, baseq, mapq, strand, is_del):
    """Host-side slot packing (numpy), copied from
    somatic_sniper_tpu/models/glfgen.py:94-102."""
    return (
        np.asarray(mapq, np.uint32)
        | (np.asarray(baseq, np.uint32) << SLOT_BASEQ_SHIFT)
        | (np.asarray(base16, np.uint32) << SLOT_BASE16_SHIFT)
        | (np.asarray(strand, np.uint32) << SLOT_STRAND_SHIFT)
        | (np.asarray(is_del, np.uint32) << SLOT_ISDEL_SHIFT)
    )


class GlfResult(NamedTuple):
    """Mirror of glf1_t (vendor glf.h:4-9) plus the aux read count."""

    lk: torch.Tensor        # [B, 10] int32 (u8 range)
    min_lk: torch.Tensor    # [B] int32
    depth: torch.Tensor     # [B] int32, non-deleted read count
    rms_mapq: torch.Tensor  # [B] int32
    # i32[1], non-zero when a count fell outside the assembly tables;
    # None where none can (the fused kernels, exact precision)
    err: torch.Tensor | None = None


def rescale_counts(c: torch.Tensor) -> torch.Tensor:
    """The c_tot > 255 depth rescale (glfgen.py:579-586, reference
    sniper_maqcns.c:178-182): c = (int)(254 * c / c_tot + 0.5) in f32
    where the class total passes 255, unchanged elsewhere."""
    c_tot = c.sum(dim=1, keepdim=True)
    scaled = torch.floor(
        254.0 * c.to(F32) / c_tot.clamp(min=1).to(F32) + 0.5).to(I32)
    return torch.where(c_tot > 255, scaled, c)


def glfgen_batch(cols: ColumnBatch, dtabs: DeviceTables,
                 cap_mapq: int = 60, precision: str = "fast") -> GlfResult:
    """Batched sniper_maqcns_glfgen (reference sniper_maqcns.c:127-248):
    f32 over any of the three encodings ("fast"), or the reference's own
    arithmetic over full u32 slot words ("exact").  ``dtabs`` must hold
    the tables of that precision.

    A fast batch deeper than 255 whose rescaled class counts fall
    outside the assembly tables does not raise here: those columns get
    zero likelihoods and ``err`` is set, and the caller must read it
    (``runner.collect_pending`` raises the stand-alone ``assembly10``'s
    ValueError on it), so that a captured step never waits."""
    _check_precision(dtabs, precision)
    if precision == "exact":
        return _glfgen_exact(cols, dtabs, cap_mapq)
    lk, min_lk, rms, n, err = _glfgen_fast(cols, dtabs, cap_mapq)
    # rms mapQ (reference sniper_maqcns.c:176)
    rms_mapq = torch.floor(
        torch.sqrt(rms.to(F32) / n.clamp(min=1).to(F32)) + 0.499
    ).to(I32)
    rms_mapq = torch.where(n > 0, rms_mapq, 0)
    return GlfResult(lk=lk, min_lk=min_lk, depth=n.clamp(max=16777215),
                     rms_mapq=rms_mapq, err=err)


def glfgen_lk(cols: ColumnBatch, dtabs: DeviceTables, cap_mapq: int = 60,
              precision: str = "fast"):
    """What the scoring step reads of ``glfgen_batch``: (lk i32[B, 10],
    the count of non-deleted reads i32[B] (unclamped in fast precision),
    err as ``GlfResult.err``).  The rms mapQ, which no device step
    reads, is left out, and with it a dozen operations a sample."""
    _check_precision(dtabs, precision)
    if precision == "exact":
        g = _glfgen_exact(cols, dtabs, cap_mapq)
        return g.lk, g.depth, g.err
    lk, _, _, n, err = _glfgen_fast(cols, dtabs, cap_mapq)
    return lk, n, err


def _check_precision(dtabs: DeviceTables, precision: str) -> None:
    if dtabs.precision != precision:
        raise ValueError(f"{precision} glfgen given {dtabs.precision} tables")


def _glfgen_fast(cols: ColumnBatch, dtabs: DeviceTables, cap_mapq: int):
    """(lk, min_lk, rms sum, n, err) of the fast precision's kernels."""
    D = cols.slots.shape[1]
    w = dtabs.fk_weights
    enc = cols.encoding
    coef_sub, lhet_sub = dtabs.assembly_tables(D)
    if D <= MAX_D:
        # c_tot <= D <= 255: no rescale, and one launch does both steps
        err = None
        if enc == "raw32":
            lk, min_lk, rms = glfgen32(cols.slots, cols.n_keep, cols.ref16,
                                       w, coef_sub, lhet_sub, cap_mapq)
            n = cols.n_keep
        elif enc == "u16":
            lk, min_lk = glfgen16(cols.slots, cols.n_keep, w, coef_sub,
                                  lhet_sub)
            rms, n = cols.rms_sum, cols.n_keep
        else:
            lk, min_lk, rms, n = glfgen_u32(cols.slots, cols.depth,
                                            cols.ref16, w, coef_sub,
                                            lhet_sub, cap_mapq)
    else:
        if enc == "raw32":
            # kept-only lanes: the first n_keep, none a deletion
            esum, fsum, c, rms, n = accumulate(cols.slots, cols.n_keep,
                                               cols.ref16, w, cap_mapq)
        elif enc == "u16":
            esum, fsum, c = accumulate16(cols.slots, cols.n_keep, w)
            rms, n = cols.rms_sum, cols.n_keep
        else:
            esum, fsum, c, rms, n = accumulate(cols.slots, cols.depth,
                                               cols.ref16, w, cap_mapq)
        # the error word stays on the device: the caller reads it with
        # the step's results
        lk, min_lk, err = assembly10_flagged(esum, fsum, rescale_counts(c),
                                             n, coef_sub, lhet_sub)
    return lk, min_lk, rms, n, err


# -- exact precision ----------------------------------------------------------

def pack_info(cols: ColumnBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-read sort keys of the reference's aux array
    (glfgen.py:105-144, reference sniper_maqcns.c:144-156):
    ``effQ<<24 | valid<<21 | strand<<18 | base2<<16 | baseQ<<8 | mapQ``
    for each non-deleted read, as int64 (torch sorts no uint32 on every
    build, and int64 keeps the unsigned order); other lanes hold
    0xFFFFFFFF, above every real key.  Returns (keys int64 [B, D], n
    int32 [B] participating reads)."""
    s = cols.slots
    B, D = s.shape
    j_idx = torch.arange(D, device=s.device)[None, :]
    keep = (j_idx < cols.depth[:, None]) & (((s >> 21) & 1) == 0)
    mapq = s & 0xFF
    q = (s >> 8) & 0xFF
    strand = (s >> 20) & 1
    qq = (s >> 16) & 0xF
    x = (strand << 18) | (q << 8) | mapq | (torch.minimum(q, mapq) << 24)
    code = torch.where(qq != 0, qq, cols.ref16[:, None])
    base2 = torch.full_like(code, 4)
    for c16, c4 in ((1, 0), (2, 1), (4, 2), (8, 3)):
        base2 = torch.where(code == c16, c4, base2)
    x = torch.where(base2 < 4, x | (1 << 21) | (base2 << 16), x)
    # effQ <= 255 fills the int32's sign bit: widen before the compare
    key = torch.where(keep, x.to(I64) & _INVALID_KEY, _INVALID_KEY)
    return key, keep.sum(dim=1, dtype=I32)


def _exact_accumulate(info_sorted, n, fk, cap_mapq: int, max_w: int = 255,
                      steps: int | None = None):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i64[B]) of the
    reference's descending scan (glfgen.py:147-198, reference
    sniper_maqcns.c:160-176) over keys sorted ascending.

    The rank a read's weight takes, the reference's ``w[k]`` at its
    visit, is the count of updating reads of its (base, strand) class
    above it, capped at ``max_w``: that, the f64 terms, c and rms are
    computed for all reads at once.  What stays serial is the sum itself,
    a float accumulator updated through a double addition: each step adds
    one sorted position's terms to the eight sums in f64 and rounds them
    back to f32, from the highest key down, so every class sees its reads
    in the reference's order (a term of 0.0 leaves a sum's bits as they
    were).

    The sum visits the top ``steps`` positions: by default all D on a
    card, as the JAX package's scan does (a fixed trip count is what a
    captured CUDA graph needs: it allows no read of ``n`` on the host),
    and on the CPU only the deepest column's, ``min(n.max(), D)``.  Both
    give the same bits.  The positions past a column's ``n`` come first
    in the descending visit, and each adds terms of +0.0 to sums that are
    still +0.0: a term is a 0/1 mask times ``fk[w] * effq`` or ``fk[w]``,
    finite and non-negative, so the product is never -0.0 (nor NaN), and
    +0.0 + +0.0 is +0.0.  From the column's ``n`` down the two visits are
    the same steps."""
    B, D = info_sorted.shape
    dev = info_sorted.device
    j_idx = torch.arange(D, device=dev)[None, :]
    alive = j_idx < n[:, None]
    effq = (info_sorted >> 24).to(I32)
    low6 = ((info_sorted >> 8) & 0x3F).to(I32)
    # effective-quality floor (reference sniper_maqcns.c:165)
    effq = torch.where((effq < 4) & (low6 != 0), 4, effq)
    k8 = (info_sorted >> 16) & 7
    k4 = k8 & 3
    upd = alive & (effq > 0)

    oh8 = (k8[:, :, None] == torch.arange(8, device=dev)) & upd[:, :, None]
    oh8 = oh8.to(I32)
    above = oh8.flip(1).cumsum(1, dtype=I32).flip(1) - oh8
    w = above.gather(2, k8[:, :, None])[:, :, 0]
    fkw = fk[w.clamp(0, max_w).long()]                     # f64 [B, D]
    oh4 = (k4[:, :, None] == torch.arange(4, device=dev)) & upd[:, :, None]
    terms = torch.cat([oh4.to(F64) * (fkw * effq.to(F64))[:, :, None],
                       oh4.to(F64) * fkw[:, :, None]], dim=2)  # [B, D, 8]
    sums = torch.zeros((B, 8), dtype=F32, device=dev)
    if steps is None:
        steps = D if dev.type == "cuda" else min(int(n.max()) if B else 0, D)
    for j in range(steps - 1, -1, -1):
        sums = (sums.to(F64) + terms[:, j]).to(F32)
    c = oh4.sum(dim=1, dtype=I32)
    mq = (info_sorted & 0x7F).clamp(max=cap_mapq)
    rms = torch.where(alive, mq * mq, 0).sum(dim=1)
    return sums[:, :4], sums[:, 4:], c, rms


def _c_trunc_half(x64: torch.Tensor) -> torch.Tensor:
    """C ``(int)(x + 0.5)`` on a nonnegative double."""
    return torch.floor(x64 + 0.5).to(I32)


def _glfgen_exact(cols: ColumnBatch, dtabs: DeviceTables,
                  cap_mapq: int) -> GlfResult:
    """The exact branch of glfgen_batch (glfgen.py:441-451, :528-536,
    :579-756 with ``acc_f`` float64 and plain gathers).  Every f64 step
    is a torch op of its own, so no multiply is fused into an add."""
    if cols.n_keep is not None:
        raise ValueError("the exact path needs the u32 slot encoding "
                         "(u16 batches are fast-path only)")
    info, n = pack_info(cols)
    esum, fsum, c, rms = _exact_accumulate(
        torch.sort(info, dim=1).values, n, dtabs.fk, cap_mapq)
    coef, lhet = dtabs.coef, dtabs.lhet
    B = esum.shape[0]
    dev = esum.device
    nz = n > 0

    # rms mapQ (reference sniper_maqcns.c:176)
    rms_mapq = torch.floor(
        torch.sqrt(rms.to(F64) / n.clamp(min=1).to(F64)) + 0.499).to(I32)
    rms_mapq = torch.where(nz, rms_mapq, 0)

    # depth rescale of c[] (reference sniper_maqcns.c:178-182)
    c_tot = c.sum(dim=1, dtype=I32)
    scaled = _c_trunc_half(
        254.0 * c.to(F64) / c_tot.clamp(min=1)[:, None].to(F64))
    c = torch.where((c_tot > 255)[:, None], scaled, c)
    c_tot = c.sum(dim=1, dtype=I32)

    # likelihood assembly (reference sniper_maqcns.c:184-214); the table
    # reads clamp to the last row like the JAX package's gathers (the
    # rescale can give a total of 256)
    last = coef.shape[1] - 1
    ct_row = c_tot.clamp(max=last).long()
    zf = torch.zeros(B, dtype=F32, device=dev)
    p = {}
    for j, k in _TRIU:
        tmp1, tmp3 = zf, zf
        tmp2 = torch.zeros(B, dtype=I32, device=dev)
        for q in range(4):
            if q not in (j, k):
                tmp1 = tmp1 + esum[:, q]
                tmp3 = tmp3 + fsum[:, q]
                tmp2 = tmp2 + c[:, q]
        ratio = torch.where(
            tmp2 > 0, tmp1 / torch.where(tmp3 == 0, torch.ones_like(tmp3),
                                         tmp3), zf)
        bar_e = _c_trunc_half(ratio.to(F64)).clamp(4, 63).long()
        cf = coef[bar_e, ct_row, tmp2.clamp(max=last).long()]
        if j == k:
            v = torch.where(tmp2 > 0, (tmp1.to(F64) + cf).to(F32), zf)
        else:
            lh = -4.343 * lhet[c[:, j].clamp(max=last).long(),
                               c[:, k].clamp(max=last).long()]
            v = torch.where(tmp2 > 0, ((lh + tmp1.to(F64)) + cf).to(F32),
                            lh.to(F32))
        # negative clamp (reference sniper_maqcns.c:212-213)
        p[j, k] = torch.maximum(v, zf)

    # "fix p[k,k]" (reference sniper_maqcns.c:216-233): the C scans'
    # tie semantics, strict comparisons, first index wins
    max1 = torch.full((B,), -1.0, dtype=F32, device=dev)
    max2 = max1.clone()
    max_k = torch.full((B,), -1, dtype=I32, device=dev)
    for q in range(4):
        e = esum[:, q]
        gt1 = e > max1
        gt2 = ~gt1 & (e > max2)
        max2 = torch.where(gt1, max1, torch.where(gt2, e, max2))
        max1 = torch.where(gt1, e, max1)
        max_k = torch.where(gt1, q, max_k)
    min1 = torch.full((B,), 1e30, dtype=F32, device=dev)
    min2 = min1.clone()
    min_k = torch.full((B,), -1, dtype=I32, device=dev)
    for q in range(4):
        d = p[q, q]
        lt1 = d < min1
        lt2 = ~lt1 & (d < min2)
        min2 = torch.where(lt1, min1, torch.where(lt2, d, min2))
        min1 = torch.where(lt1, d, min1)
        min_k = torch.where(lt1, q, min_k)
    min1_d = min1.to(F64)
    fix = (max1 > max2) & ((min_k != max_k) | (min1_d + 1.0 > min2.to(F64)))
    fixed_val = torch.where(min1_d > 1.0, (min1_d - 1.0).to(F32), zf)
    for q in range(4):
        p[q, q] = torch.where(fix & (max_k == q), fixed_val, p[q, q])

    # quantization to glf1_t (reference sniper_maqcns.c:236-244)
    p10 = torch.stack([p[jk] for jk in _TRIU], dim=1)
    min_p = p10.amin(dim=1)
    min_lk = torch.where(min_p.to(F64) > 255.0, 255,
                         _c_trunc_half(min_p.to(F64)))
    dlk = (p10 - min_p[:, None]).to(F64)  # the subtraction is f32, as in C
    lk = torch.where(dlk > 255.0, 255, _c_trunc_half(dlk))
    # empty columns: calloc'd glf (reference sniper_maqcns.c:131-136)
    lk = torch.where(nz[:, None], lk, 0)
    min_lk = torch.where(nz, min_lk, 0)
    return GlfResult(lk=lk, min_lk=min_lk, depth=n.clamp(max=16777215),
                     rms_mapq=rms_mapq)
