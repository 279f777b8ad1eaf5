"""Batched MAQ genotype likelihoods (glfgen), fast f32 slab branch.

Port of the raw kept-only u32 branch of
somatic_sniper_tpu/models/glfgen.py (:201-288, :459-486, :528-577):
``accumulate32`` (rank-weighted class sums and the rms-mapQ sum) then
``assembly10`` (ten-genotype likelihoods), both hand-written CUDA
kernels on the card with plain torch versions on the CPU.  The exact
f64 glfgen is not part of this module: exact precision is scored by the
native host layer.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.glfgen_kernels import accumulate32, assembly10
from .tables import DeviceTables

F32 = torch.float32
I32 = torch.int32


class ColumnBatch(NamedTuple):
    """Raw kept-only slab lanes of one sample.

    ``slots`` [B, D] int32 slot words ``mapQ | baseQ<<8 | base16<<16 |
    strand<<20`` with deletions filtered out (first ``n_keep[b]`` lanes
    occupied); ``depth`` is the raw column depth including deletions,
    which the consensus model needs."""

    slots: torch.Tensor   # [B, D] int32
    depth: torch.Tensor   # [B] int32
    ref16: torch.Tensor   # [B] int32
    n_keep: torch.Tensor  # [B] int32


class GlfResult(NamedTuple):
    """Mirror of glf1_t (vendor glf.h:4-9) plus the aux read count."""

    lk: torch.Tensor        # [B, 10] int32 (u8 range)
    min_lk: torch.Tensor    # [B] int32
    depth: torch.Tensor     # [B] int32, non-deleted read count
    rms_mapq: torch.Tensor  # [B] int32


def glfgen_batch(cols: ColumnBatch, dtabs: DeviceTables,
                 cap_mapq: int = 60) -> GlfResult:
    """Batched sniper_maqcns_glfgen (reference sniper_maqcns.c:127-248)
    over raw kept-only lanes, f32 ("fast" precision)."""
    D = cols.slots.shape[1]
    esum, fsum, c, rms = accumulate32(
        cols.slots, cols.n_keep, cols.ref16, dtabs.fk_weights, cap_mapq)
    n = cols.n_keep
    nz = n > 0
    # rms mapQ (reference sniper_maqcns.c:176)
    rms_mapq = torch.floor(
        torch.sqrt(rms.to(F32) / n.clamp(min=1).to(F32)) + 0.499
    ).to(I32)
    rms_mapq = torch.where(nz, rms_mapq, 0)
    coef_sub, lhet_sub = dtabs.assembly_tables(D)
    lk, min_lk = assembly10(esum, fsum, c, n, coef_sub, lhet_sub)
    return GlfResult(lk=lk, min_lk=min_lk, depth=n.clamp(max=16777215),
                     rms_mapq=rms_mapq)
