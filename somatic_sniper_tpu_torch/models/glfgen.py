"""Batched MAQ genotype likelihoods (glfgen), fast f32 precision.

Port of the fast branch of somatic_sniper_tpu/models/glfgen.py
(:53-85, :453-527, :528-586): an accumulate (rank-weighted class sums)
then the assembly (ten-genotype likelihoods), hand-written CUDA kernels
on the card with plain torch versions on the CPU.  The kernel follows
the batch's slot encoding, and to depth 255 the two steps are one launch:

* raw kept-only int32 lanes with ``n_keep`` -> ``glfgen32``
  (``accumulate32`` above depth 255, which no slab reaches);
* compact u16 lanes with ``n_keep`` and ``rms_sum`` -> ``glfgen16``
  (``accumulate16``);
* full u32 slot words with ``depth`` -> ``glfgen_u32`` (``accumulate``).

Batches deeper than 255 take the accumulate alone, rescale their class
counts (reference sniper_maqcns.c:178-182) and run ``assembly10`` with
the full tables.  The exact
f64 glfgen is not part of this module: exact precision is scored by the
native host layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.glfgen_kernels import (MAX_D, accumulate, accumulate16,
                                  accumulate32, assembly10, glfgen16,
                                  glfgen32, glfgen_u32)
from .tables import DeviceTables

F32 = torch.float32
I32 = torch.int32


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


class GlfResult(NamedTuple):
    """Mirror of glf1_t (vendor glf.h:4-9) plus the aux read count."""

    lk: torch.Tensor        # [B, 10] int32 (u8 range)
    min_lk: torch.Tensor    # [B] int32
    depth: torch.Tensor     # [B] int32, non-deleted read count
    rms_mapq: torch.Tensor  # [B] int32


def rescale_counts(c: torch.Tensor) -> torch.Tensor:
    """The c_tot > 255 depth rescale (glfgen.py:579-586, reference
    sniper_maqcns.c:178-182): c = (int)(254 * c / c_tot + 0.5) in f32
    where the class total passes 255, unchanged elsewhere."""
    c_tot = c.sum(dim=1, keepdim=True)
    scaled = torch.floor(
        254.0 * c.to(F32) / c_tot.clamp(min=1).to(F32) + 0.5).to(I32)
    return torch.where(c_tot > 255, scaled, c)


def glfgen_batch(cols: ColumnBatch, dtabs: DeviceTables,
                 cap_mapq: int = 60) -> GlfResult:
    """Batched sniper_maqcns_glfgen (reference sniper_maqcns.c:127-248),
    f32 ("fast" precision), over any of the three encodings."""
    D = cols.slots.shape[1]
    w = dtabs.fk_weights
    enc = cols.encoding
    coef_sub, lhet_sub = dtabs.assembly_tables(D)
    if D <= MAX_D:
        # c_tot <= D <= 255: no rescale, and one launch does both steps
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
            esum, fsum, c, rms = accumulate32(cols.slots, cols.n_keep,
                                              cols.ref16, w, cap_mapq)
            n = cols.n_keep
        elif enc == "u16":
            esum, fsum, c = accumulate16(cols.slots, cols.n_keep, w)
            rms, n = cols.rms_sum, cols.n_keep
        else:
            esum, fsum, c, rms, n = accumulate(cols.slots, cols.depth,
                                               cols.ref16, w, cap_mapq)
        lk, min_lk = assembly10(esum, fsum, rescale_counts(c), n, coef_sub,
                                lhet_sub)
    # rms mapQ (reference sniper_maqcns.c:176)
    rms_mapq = torch.floor(
        torch.sqrt(rms.to(F32) / n.clamp(min=1).to(F32)) + 0.499
    ).to(I32)
    rms_mapq = torch.where(n > 0, rms_mapq, 0)
    return GlfResult(lk=lk, min_lk=min_lk, depth=n.clamp(max=16777215),
                     rms_mapq=rms_mapq)
