"""The glfgen kernels: CUDA wrappers, their plain torch versions, and
launch counters.

``accumulate32``, ``accumulate``, ``accumulate16`` and ``assembly10``
replace the Pallas kernels of the same names in
somatic_sniper_tpu/ops/pallas_glfgen.py (sources in ``csrc/``).  The
three accumulates read the same 256-entry f32 weight table
(models.tables.fk_weights_f32).  ``glfgen32``, ``glfgen_u32`` and
``glfgen16`` are an accumulate and the assembly in one launch, for
batches no deeper than 255: the class sums go from the rank to the
assembly in registers, and no error word is read (the counts index
inside the tables by construction).  Each wrapper checks its inputs,
then

* for tensors on the CPU, runs the plain torch version;
* for CUDA tensors, launches the kernel on the current stream and
  counts the launch in :data:`LAUNCHES` — or raises.  There is no
  fallback from the card to the plain version.

Slot words cross into torch as int32: their bits stay below 2^22
(``mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21``).  Compact
lanes cross as uint16 (``effq | base2<<8 | strand<<10``).
"""

from __future__ import annotations

import torch

from ..models.tables import MAX_W

F32 = torch.float32
I32 = torch.int32
U16 = torch.uint16
# deepest batch of the fused kernels and accumulate32: the class totals
# index the tables without the c_tot > 255 rescale
MAX_D = 255
MAX_RANK_D = 1 << 24  # depth bound of accumulate / accumulate16
# the c_tot > 255 rescale (models.glfgen.rescale_counts) can round four
# exact halves up to a total of 256; the full-depth tables take it
MAX_C_TOT = 256

# kernel launches since the last reset_launches(); a wrapper adds one
# only where it launches its CUDA kernel (score_columns: ops/score_kernels)
LAUNCHES = {"accumulate32": 0, "accumulate": 0, "accumulate16": 0,
            "assembly10": 0, "glfgen32": 0, "glfgen": 0, "glfgen16": 0,
            "score_columns": 0}

_NEG_PHRED = torch.tensor(-4.343, dtype=F32)
_BIG = torch.tensor(1e30, dtype=F32)
_TRIU = [(j, k) for j in range(4) for k in range(j, 4)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(fn_name: str, *args) -> None:
    from .build import load_library

    lib = load_library()
    rc = getattr(lib, fn_name)(*args)
    if rc != 0:
        msg = lib.sniper_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} (cuda error {rc})")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


# -- accumulate32 -------------------------------------------------------------

def _rank_sums_u32(slots, alive0, ref16, weights, cap_mapq: int):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i32[B], n i32[B])
    over the slot words where ``alive0`` holds, in torch ops.

    Follows somatic_sniper_tpu/models/glfgen.py pack_info +
    _fast_accumulate (:105-144, :201-288): one sort on the composite
    class-major, key-descending word (the key ranks by the RAW
    min(baseQ, mapQ), as the reference does), then the within-class rank
    of each entry as a cumsum minus the cumsum at its class start
    (gathers where the TPU used one-hot contractions)."""
    B, D = slots.shape
    dev = slots.device
    j_idx = torch.arange(D, device=dev)[None, :]
    n = alive0.sum(dim=1, dtype=I32)
    s = slots
    mapq = s & 0xFF
    q = (s >> 8) & 0xFF
    strand = (s >> 20) & 1
    qq = (s >> 16) & 0xF
    code = torch.where(qq != 0, qq, ref16[:, None])
    base2 = torch.full_like(code, 4)
    for c16, c4 in ((1, 0), (2, 1), (4, 2), (8, 3)):
        base2 = torch.where(code == c16, c4, base2)
    has_base = base2 < 4
    k8_0 = strand * 4 + torch.where(has_base, base2, 0)

    mq0 = torch.clamp(mapq & 0x7F, max=cap_mapq)
    rms = torch.where(alive0, mq0 * mq0, 0).sum(dim=1, dtype=I32)

    # class-major, subkey-descending composite key; pads sort last
    ck = ((torch.minimum(q, mapq).long() << 17) | (has_base.long() << 16)
          | (q.long() << 8) | mapq.long())
    key2 = (k8_0.long() << 26) | (((1 << 25) - 1) - ck)
    key2 = torch.where(alive0, key2, 0xFFFFFFFF)
    key2 = torch.sort(key2, dim=1).values

    alive = j_idx < n[:, None]
    k8 = (key2 >> 26) & 7
    ck_s = ((1 << 25) - 1) - (key2 & ((1 << 26) - 1))
    effq = ck_s >> 17
    low6 = (ck_s >> 8) & 0x3F
    effq = torch.where((effq < 4) & (low6 != 0), 4, effq)
    k4 = k8 & 3
    upd = alive & (effq > 0)

    # rank among upd entries of the same class = the reference's w[k]
    upd_i = upd.long()
    cs_excl = torch.cumsum(upd_i, dim=1) - upd_i
    class_cnt = torch.stack(
        [((k8 == k) & alive).sum(dim=1) for k in range(8)], dim=1)
    seg_start = torch.cumsum(class_cnt, dim=1) - class_cnt
    cs_at_start = cs_excl.gather(1, seg_start.clamp(max=D - 1))
    rank = cs_excl - cs_at_start.gather(1, k8)

    fkw = weights[rank.clamp(0, MAX_W)] * upd.to(F32)
    eterm = fkw * effq.to(F32)
    zero = torch.zeros((), dtype=F32, device=dev)
    esum = torch.stack(
        [torch.where(k4 == b, eterm, zero).sum(dim=1) for b in range(4)], 1)
    fsum = torch.stack(
        [torch.where(k4 == b, fkw, zero).sum(dim=1) for b in range(4)], 1)
    c = torch.stack(
        [(upd & (k4 == b)).sum(dim=1, dtype=I32) for b in range(4)], 1)
    return esum, fsum, c, rms, n


def accumulate32_plain(slots, n_keep, ref16, weights, cap_mapq: int):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i32[B]) in torch
    ops, over raw kept-only lanes (the first n_keep of each row)."""
    alive0 = (torch.arange(slots.shape[1], device=slots.device)[None, :]
              < n_keep[:, None])
    return _rank_sums_u32(slots, alive0, ref16, weights, cap_mapq)[:4]


def accumulate32(slots, n_keep, ref16, weights, cap_mapq: int):
    """Rank-weighted class sums over raw kept-only slab lanes.

    ``slots`` i32[B, D] (D <= 255), ``n_keep``/``ref16`` i32[B],
    ``weights`` the f32[256] rank-weight table
    (models.tables.fk_weights_f32).  Returns (esum f32[B,4],
    fsum f32[B,4], c i32[B,4], rms i32[B]); c and rms are exact, the
    sums agree with the plain version to f32 summation order.

    No path launches it (slabs take ``glfgen32`` to D 255 and
    ``accumulate`` deeper): it is ``glfgen32``'s first half on its own,
    which the card tests and chip_smoke hold to its plain version and
    time beside the fused kernel."""
    if slots.dim() != 2:
        raise ValueError(f"slots: expected [B, D], got {tuple(slots.shape)}")
    B, D = slots.shape
    dev = slots.device
    if not 1 <= D <= MAX_D:
        raise ValueError(f"slab depth D={D} outside [1, {MAX_D}]")
    _check("slots", slots, I32, (B, D), dev)
    _check("n_keep", n_keep, I32, (B,), dev)
    _check("ref16", ref16, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return accumulate32_plain(slots, n_keep, ref16, weights, cap_mapq)
    if dev.type != "cuda":
        raise ValueError(f"accumulate32: unsupported device {dev}")
    esum = torch.empty((B, 4), dtype=F32, device=dev)
    fsum = torch.empty((B, 4), dtype=F32, device=dev)
    c = torch.empty((B, 4), dtype=I32, device=dev)
    rms = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return esum, fsum, c, rms
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_accumulate32", _ptr(slots), _ptr(n_keep),
                _ptr(ref16), _ptr(weights), _ptr(esum), _ptr(fsum),
                _ptr(c), _ptr(rms), B, D, int(cap_mapq), stream)
    LAUNCHES["accumulate32"] += 1
    return esum, fsum, c, rms


def _scratch(B: int, D: int, dev) -> torch.Tensor | None:
    """The global key scratch the rank layout needs for a [B, D] batch
    (csrc/class_rank.cuh: columns past 16384 keys), or None."""
    from .build import load_library

    n = load_library().sniper_rank_scratch_ints(B, D)
    return torch.empty(n, dtype=I32, device=dev) if n else None


def _check_rank_depth(name: str, D: int) -> None:
    if not 1 <= D <= MAX_RANK_D:
        raise ValueError(f"{name}: depth D={D} outside [1, {MAX_RANK_D}]")


# -- accumulate ---------------------------------------------------------------

def accumulate_plain(slots, depth, ref16, weights, cap_mapq: int):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i32[B], n i32[B])
    in torch ops over full slot words: lanes below ``depth`` whose
    is_del bit (21) is clear take part (glfgen.py:105-144, 201-288)."""
    j_idx = torch.arange(slots.shape[1], device=slots.device)[None, :]
    alive0 = (j_idx < depth[:, None]) & (((slots >> 21) & 1) == 0)
    return _rank_sums_u32(slots, alive0, ref16, weights, cap_mapq)


def accumulate(slots, depth, ref16, weights, cap_mapq: int):
    """Rank-weighted class sums over full u32 slot words that still hold
    deletions.

    ``slots`` i32[B, D] (any D >= 1; the first ``depth[b]`` lanes of row
    b occupied), ``depth``/``ref16`` i32[B], ``weights`` the f32[256]
    rank-weight table.  Returns (esum f32[B,4], fsum f32[B,4],
    c i32[B,4], rms i32[B], n i32[B]); c, rms and n are exact, the sums
    agree with the plain version to f32 summation order."""
    if slots.dim() != 2:
        raise ValueError(f"slots: expected [B, D], got {tuple(slots.shape)}")
    B, D = slots.shape
    dev = slots.device
    _check_rank_depth("accumulate", D)
    _check("slots", slots, I32, (B, D), dev)
    _check("depth", depth, I32, (B,), dev)
    _check("ref16", ref16, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return accumulate_plain(slots, depth, ref16, weights, cap_mapq)
    if dev.type != "cuda":
        raise ValueError(f"accumulate: unsupported device {dev}")
    esum = torch.empty((B, 4), dtype=F32, device=dev)
    fsum = torch.empty((B, 4), dtype=F32, device=dev)
    c = torch.empty((B, 4), dtype=I32, device=dev)
    rms = torch.empty((B,), dtype=I32, device=dev)
    n = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return esum, fsum, c, rms, n
    with torch.cuda.device(dev):
        scratch = _scratch(B, D, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_accumulate", _ptr(slots), _ptr(depth), _ptr(ref16),
                _ptr(weights), _ptr(esum), _ptr(fsum), _ptr(c), _ptr(rms),
                _ptr(n), 0 if scratch is None else _ptr(scratch),
                0 if scratch is None else scratch.numel(), B, D,
                int(cap_mapq), stream)
    LAUNCHES["accumulate"] += 1
    return esum, fsum, c, rms, n


# -- accumulate16 -------------------------------------------------------------

def accumulate16_plain(slots16, n_keep, weights):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4]) in torch ops over
    compact u16 lanes, following glfgen.py _fast_accumulate16
    (:291-351): one sort on ``class<<9 | (255 - effq)``, the rank as the
    position minus the class start.  The lanes are widened on their own
    device (through int16, whose conversions every backend has)."""
    B, D = slots16.shape
    dev = slots16.device
    s = slots16.view(torch.int16).to(I32) & 0xFFFF
    j_idx = torch.arange(D, device=dev)[None, :]
    occupied = j_idx < n_keep[:, None]
    eff0 = s & 0xFF
    k8_0 = ((s >> 10) & 1) * 4 + ((s >> 8) & 3)
    upd0 = occupied & (eff0 > 0)

    # class-major, effq-descending key; non-participants pad last
    pad = (1 << 14) - 1
    key = torch.where(upd0, (k8_0 << 9) | (255 - eff0), pad)
    key = torch.sort(key, dim=1).values
    valid = key != pad
    k8 = torch.where(valid, key >> 9, 7)
    eff = torch.where(valid, 255 - (key & 0x1FF), 0)
    k4 = k8 & 3

    valid_i = valid.long()
    cs_excl = torch.cumsum(valid_i, dim=1) - valid_i
    class_cnt = torch.stack(
        [((k8 == k) & valid).sum(dim=1) for k in range(8)], dim=1)
    seg_start = torch.cumsum(class_cnt, dim=1) - class_cnt
    rank = cs_excl - seg_start.gather(1, k8.long())

    fkw = weights[rank.clamp(0, MAX_W)] * valid.to(F32)
    eterm = fkw * eff.to(F32)
    zero = torch.zeros((), dtype=F32, device=dev)
    esum = torch.stack(
        [torch.where(k4 == b, eterm, zero).sum(dim=1) for b in range(4)], 1)
    fsum = torch.stack(
        [torch.where(k4 == b, fkw, zero).sum(dim=1) for b in range(4)], 1)
    c = torch.stack(
        [(valid & (k4 == b)).sum(dim=1, dtype=I32) for b in range(4)], 1)
    return esum, fsum, c


def accumulate16(slots16, n_keep, weights):
    """Rank-weighted class sums over compact u16 lanes.

    ``slots16`` u16[B, D] (any D >= 1; the first ``n_keep[b]`` lanes of
    row b occupied), ``n_keep`` i32[B], ``weights`` the f32[256]
    rank-weight table.  Returns (esum f32[B,4], fsum f32[B,4],
    c i32[B,4]); c is exact, the sums agree with the plain version to
    f32 summation order.  The host supplies rms."""
    if slots16.dim() != 2:
        raise ValueError(
            f"slots16: expected [B, D], got {tuple(slots16.shape)}")
    B, D = slots16.shape
    dev = slots16.device
    _check_rank_depth("accumulate16", D)
    _check("slots16", slots16, U16, (B, D), dev)
    _check("n_keep", n_keep, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return accumulate16_plain(slots16, n_keep, weights)
    if dev.type != "cuda":
        raise ValueError(f"accumulate16: unsupported device {dev}")
    esum = torch.empty((B, 4), dtype=F32, device=dev)
    fsum = torch.empty((B, 4), dtype=F32, device=dev)
    c = torch.empty((B, 4), dtype=I32, device=dev)
    if B == 0:
        return esum, fsum, c
    with torch.cuda.device(dev):
        scratch = _scratch(B, D, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_accumulate16", _ptr(slots16), _ptr(n_keep),
                _ptr(weights), _ptr(esum), _ptr(fsum), _ptr(c),
                0 if scratch is None else _ptr(scratch),
                0 if scratch is None else scratch.numel(), B, D, stream)
    LAUNCHES["accumulate16"] += 1
    return esum, fsum, c


# -- assembly10 ---------------------------------------------------------------

def _max_c_tot(NK: int) -> int:
    """Largest class total the tables of depth NK - 1 take: NK - 1, and
    also MAX_C_TOT for the full-depth tables, whose row 255 then serves
    c_tot = 256 (the JAX package's gather clamps there; the reference
    reads past its table)."""
    return MAX_C_TOT if NK == MAX_D + 1 else NK - 1


def _count_error(NK: int) -> str:
    return (f"class counts outside [0, {NK - 1}] or summing past the table "
            f"depth {_max_c_tot(NK)}: c must come from a slab of depth <= "
            f"{NK - 1}, or from the c_tot > 255 rescale")


def assembly10_plain(esum, fsum, c, n, coef_sub, lhet_sub):
    """(lk i32[B,10], min_lk i32[B]) in torch ops.

    Follows the XLA assembly of somatic_sniper_tpu/models/glfgen.py
    (:579-752) operation for operation in f32, with gathers in place of
    the one-hot contractions (a gather is an exact copy)."""
    B = esum.shape[0]
    NK = coef_sub.shape[1]
    dev = esum.device
    c_tot = c.sum(dim=1)
    if B and (int(c.min()) < 0 or int(c_tot.max()) > _max_c_tot(NK)):
        raise ValueError(_count_error(NK))
    ct_row = c_tot.clamp(max=NK - 1)
    coef_flat = coef_sub.reshape(-1)
    lhet_flat = lhet_sub.reshape(-1)
    zf = torch.zeros(B, dtype=F32, device=dev)
    zi = torch.zeros(B, dtype=I32, device=dev)
    one = torch.ones((), dtype=F32, device=dev)
    neg_phred = _NEG_PHRED.to(dev)

    p = []
    for j, k in _TRIU:
        tmp1, tmp3, tmp2 = zf, zf, zi
        for q in range(4):
            if q not in (j, k):
                tmp1 = tmp1 + esum[:, q]
                tmp3 = tmp3 + fsum[:, q]
                tmp2 = tmp2 + c[:, q]
        ratio = torch.where(tmp2 > 0,
                            tmp1 / torch.where(tmp3 == 0, one, tmp3), zf)
        be = torch.floor(ratio + 0.5).to(I32).clamp(4, 63)
        cf = coef_flat[((be.long() - 4) * NK + ct_row) * NK + tmp2]
        if j == k:
            v = torch.where(tmp2 > 0, tmp1 + cf, zf)
        else:
            lh = neg_phred * lhet_flat[c[:, j].long() * NK + c[:, k]]
            v = torch.where(tmp2 > 0, (lh + tmp1) + cf, lh)
        p.append(torch.where(v < 0, zf, v))

    # fix p[k,k]: C scan tie semantics, strict comparisons, first wins
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
    diag = [t for t, (j, k) in enumerate(_TRIU) if j == k]
    big = _BIG.to(dev)
    min1 = big.expand(B).clone()
    min2 = min1.clone()
    min_k = torch.full((B,), -1, dtype=I32, device=dev)
    for q in range(4):
        d = p[diag[q]]
        lt1 = d < min1
        lt2 = ~lt1 & (d < min2)
        min2 = torch.where(lt1, min1, torch.where(lt2, d, min2))
        min1 = torch.where(lt1, d, min1)
        min_k = torch.where(lt1, q, min_k)
    fix = (max1 > max2) & ((min_k != max_k) | (min1 + 1.0 > min2))
    fixed_val = torch.where(min1 > 1.0, min1 - 1.0, zf)
    for q in range(4):
        t = diag[q]
        p[t] = torch.where(fix & (max_k == q), fixed_val, p[t])

    # quantization; empty columns are all-zero
    p10 = torch.stack(p, dim=1)
    min_p = p10.amin(dim=1)
    nz = n > 0
    dlk = p10 - min_p[:, None]
    lk = torch.where(dlk > 255.0, 255, torch.floor(dlk + 0.5).to(I32))
    min_lk = torch.where(min_p > 255.0, 255,
                         torch.floor(min_p + 0.5).to(I32))
    lk = torch.where(nz[:, None], lk, 0)
    min_lk = torch.where(nz, min_lk, 0)
    return lk, min_lk


def _check_assembly_tables(coef_sub, lhet_sub, dev) -> int:
    """NK of the assembly tables ``coef[4:64, :NK, :NK]`` and
    ``lhet[:NK, :NK]``, checked."""
    if not isinstance(coef_sub, torch.Tensor) or coef_sub.dim() != 3:
        raise ValueError("coef_sub: expected [60, NK, NK]")
    NK = coef_sub.shape[1]
    if not 1 <= NK <= MAX_D + 1:
        raise ValueError(
            f"table depth NK={NK} outside [1, {MAX_D + 1}]: deeper "
            "batches take the c_tot > 255 rescale and NK = 256")
    _check("coef_sub", coef_sub, F32, (60, NK, NK), dev)
    _check("lhet_sub", lhet_sub, F32, (NK, NK), dev)
    return NK


def _check_assembly_inputs(esum, fsum, c, n, coef_sub, lhet_sub):
    """(B, NK, device) of an assembly call, its six tensors checked."""
    if not isinstance(esum, torch.Tensor) or esum.dim() != 2:
        raise ValueError("esum: expected [B, 4]")
    B = esum.shape[0]
    dev = esum.device
    NK = _check_assembly_tables(coef_sub, lhet_sub, dev)
    _check("esum", esum, F32, (B, 4), dev)
    _check("fsum", fsum, F32, (B, 4), dev)
    _check("c", c, I32, (B, 4), dev)
    _check("n", n, I32, (B,), dev)
    return B, NK, dev


def assembly10_launch(esum, fsum, c, n, coef_sub, lhet_sub):
    """``assembly10`` on CUDA tensors without the wait: launches the
    kernel and returns (lk, min_lk, err), ``err`` an i32[1] on the card
    that the kernel sets to 1 if any column's counts would index past
    the tables (such a column reads no table and gets zeros).  The
    caller reads ``err`` when it next waits for the device."""
    B, NK, dev = _check_assembly_inputs(esum, fsum, c, n, coef_sub, lhet_sub)
    if dev.type != "cuda":
        raise ValueError(f"assembly10: no kernel for device {dev}")
    lk = torch.empty((B, 10), dtype=I32, device=dev)
    min_lk = torch.empty((B,), dtype=I32, device=dev)
    with torch.cuda.device(dev):
        err = torch.zeros(1, dtype=I32, device=dev)
        if B == 0:
            return lk, min_lk, err
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_assembly10", _ptr(esum), _ptr(fsum), _ptr(c),
                _ptr(n), _ptr(coef_sub), _ptr(lhet_sub), _ptr(lk),
                _ptr(min_lk), _ptr(err), B, NK, stream)
    LAUNCHES["assembly10"] += 1
    return lk, min_lk, err


def assembly10_flagged(esum, fsum, c, n, coef_sub, lhet_sub):
    """``assembly10`` with its error word left on the device: (lk,
    min_lk, err), ``err`` an i32[1] that is 1 if any column's counts
    fell outside the tables (such a column gets zeros), for a caller
    that reads it with its results (``runner.collect_pending``), since a
    captured step may not wait.  On the card ``assembly10_launch``; on
    the CPU the plain version over the columns inside the tables."""
    if isinstance(esum, torch.Tensor) and esum.device.type == "cpu":
        _, NK, _ = _check_assembly_inputs(esum, fsum, c, n, coef_sub,
                                          lhet_sub)
        ok = (c.amin(dim=1) >= 0) & (c.sum(dim=1) <= _max_c_tot(NK))
        lk, min_lk = assembly10_plain(esum, fsum, torch.where(
            ok[:, None], c, 0), n, coef_sub, lhet_sub)
        return (torch.where(ok[:, None], lk, 0), torch.where(ok, min_lk, 0),
                (~ok).any().to(I32).reshape(1))
    return assembly10_launch(esum, fsum, c, n, coef_sub, lhet_sub)


def assembly10(esum, fsum, c, n, coef_sub, lhet_sub):
    """The ten-genotype likelihood assembly.

    ``coef_sub`` is ``coef[4:64, :NK, :NK]`` f32 and ``lhet_sub``
    ``lhet[:NK, :NK]`` f32 with NK = min(D, 255) + 1 for a batch of
    depth D, so the class totals (<= D, or <= 256 after the c_tot > 255
    rescale that deeper batches take first, models.glfgen.rescale_counts)
    index inside the tables; c_tot = 256 reads row 255.  Counts outside
    that (a negative class count, or a total past the table) raise
    ValueError on either device; on the card the kernel flags them and
    this wrapper waits for the flag (``assembly10_launch`` is the same
    launch without the wait).  Returns (lk i32[B,10], min_lk i32[B]),
    bit-identical to the plain version on the same inputs."""
    if isinstance(esum, torch.Tensor) and esum.device.type == "cpu":
        _check_assembly_inputs(esum, fsum, c, n, coef_sub, lhet_sub)
        return assembly10_plain(esum, fsum, c, n, coef_sub, lhet_sub)
    lk, min_lk, err = assembly10_launch(esum, fsum, c, n, coef_sub, lhet_sub)
    # reading the flag waits for the kernel
    if int(err.item()):
        raise ValueError(_count_error(coef_sub.shape[1]))
    return lk, min_lk


# -- an accumulate and the assembly in one launch (D <= 255) -------------------

def _check_fused(name: str, slots, dtype, coef_sub, lhet_sub):
    """(B, D, NK, device) of a fused call: [B, D] lanes of ``dtype`` with
    1 <= D <= 255, and assembly tables of depth NK - 1 >= D, so that the
    class totals (<= D) index inside them."""
    if not isinstance(slots, torch.Tensor) or slots.dim() != 2:
        raise ValueError(f"{name}: expected [B, D] lanes")
    B, D = slots.shape
    dev = slots.device
    if not 1 <= D <= MAX_D:
        raise ValueError(
            f"{name}: depth D={D} outside [1, {MAX_D}]: deeper batches "
            "take the accumulate, the c_tot > 255 rescale and assembly10")
    _check("slots", slots, dtype, (B, D), dev)
    NK = _check_assembly_tables(coef_sub, lhet_sub, dev)
    if NK <= D:
        raise ValueError(f"{name}: tables of depth {NK - 1} for a batch of "
                         f"depth {D}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return B, D, NK, dev


def glfgen32_plain(slots, n_keep, ref16, weights, coef_sub, lhet_sub,
                   cap_mapq: int):
    """(lk, min_lk, rms): accumulate32_plain, then assembly10_plain."""
    esum, fsum, c, rms = accumulate32_plain(slots, n_keep, ref16, weights,
                                            cap_mapq)
    lk, min_lk = assembly10_plain(esum, fsum, c, n_keep, coef_sub, lhet_sub)
    return lk, min_lk, rms


def glfgen32(slots, n_keep, ref16, weights, coef_sub, lhet_sub,
             cap_mapq: int):
    """``accumulate32`` and ``assembly10`` in one launch, over raw
    kept-only slab lanes (inputs as ``accumulate32``, tables as
    ``assembly10`` with NK > D).  Returns (lk i32[B,10], min_lk i32[B],
    rms i32[B]); a column is empty where ``n_keep`` is 0."""
    B, D, NK, dev = _check_fused("glfgen32", slots, I32, coef_sub, lhet_sub)
    _check("n_keep", n_keep, I32, (B,), dev)
    _check("ref16", ref16, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return glfgen32_plain(slots, n_keep, ref16, weights, coef_sub,
                              lhet_sub, cap_mapq)
    lk = torch.empty((B, 10), dtype=I32, device=dev)
    min_lk = torch.empty((B,), dtype=I32, device=dev)
    rms = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return lk, min_lk, rms
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_glfgen32", _ptr(slots), _ptr(n_keep), _ptr(ref16),
                _ptr(weights), _ptr(coef_sub), _ptr(lhet_sub), _ptr(lk),
                _ptr(min_lk), _ptr(rms), B, D, NK, int(cap_mapq), stream)
    LAUNCHES["glfgen32"] += 1
    return lk, min_lk, rms


def glfgen_u32_plain(slots, depth, ref16, weights, coef_sub, lhet_sub,
                     cap_mapq: int):
    """(lk, min_lk, rms, n): accumulate_plain, then assembly10_plain."""
    esum, fsum, c, rms, n = accumulate_plain(slots, depth, ref16, weights,
                                             cap_mapq)
    lk, min_lk = assembly10_plain(esum, fsum, c, n, coef_sub, lhet_sub)
    return lk, min_lk, rms, n


def glfgen_u32(slots, depth, ref16, weights, coef_sub, lhet_sub,
               cap_mapq: int):
    """``accumulate`` and ``assembly10`` in one launch, over full u32
    slot words that still hold deletions (inputs as ``accumulate`` with
    D <= 255, tables as ``assembly10`` with NK > D).  Returns
    (lk i32[B,10], min_lk i32[B], rms i32[B], n i32[B]); a column is
    empty where n, its count of non-deleted lanes, is 0."""
    B, D, NK, dev = _check_fused("glfgen_u32", slots, I32, coef_sub,
                                 lhet_sub)
    _check("depth", depth, I32, (B,), dev)
    _check("ref16", ref16, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return glfgen_u32_plain(slots, depth, ref16, weights, coef_sub,
                                lhet_sub, cap_mapq)
    lk = torch.empty((B, 10), dtype=I32, device=dev)
    min_lk = torch.empty((B,), dtype=I32, device=dev)
    rms = torch.empty((B,), dtype=I32, device=dev)
    n = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return lk, min_lk, rms, n
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_glfgen", _ptr(slots), _ptr(depth), _ptr(ref16),
                _ptr(weights), _ptr(coef_sub), _ptr(lhet_sub), _ptr(lk),
                _ptr(min_lk), _ptr(rms), _ptr(n), B, D, NK, int(cap_mapq),
                stream)
    LAUNCHES["glfgen"] += 1
    return lk, min_lk, rms, n


def glfgen16_plain(slots16, n_keep, weights, coef_sub, lhet_sub):
    """(lk, min_lk): accumulate16_plain, then assembly10_plain."""
    esum, fsum, c = accumulate16_plain(slots16, n_keep, weights)
    return assembly10_plain(esum, fsum, c, n_keep, coef_sub, lhet_sub)


def glfgen16(slots16, n_keep, weights, coef_sub, lhet_sub):
    """``accumulate16`` and ``assembly10`` in one launch, over compact
    u16 lanes (inputs as ``accumulate16`` with D <= 255, tables as
    ``assembly10`` with NK > D).  Returns (lk i32[B,10],
    min_lk i32[B]); a column is empty where ``n_keep`` is 0."""
    B, D, NK, dev = _check_fused("glfgen16", slots16, U16, coef_sub,
                                 lhet_sub)
    _check("n_keep", n_keep, I32, (B,), dev)
    _check("weights", weights, F32, (MAX_W + 1,), dev)
    if dev.type == "cpu":
        return glfgen16_plain(slots16, n_keep, weights, coef_sub, lhet_sub)
    lk = torch.empty((B, 10), dtype=I32, device=dev)
    min_lk = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return lk, min_lk
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_glfgen16", _ptr(slots16), _ptr(n_keep),
                _ptr(weights), _ptr(coef_sub), _ptr(lhet_sub), _ptr(lk),
                _ptr(min_lk), B, D, NK, stream)
    LAUNCHES["glfgen16"] += 1
    return lk, min_lk


def empty_launch(blocks: int, threads: int, dev) -> None:
    """Launches csrc/launch_floor.cu's empty kernel on the current stream
    of the CUDA device ``dev``: what a launch of that grid costs with no
    work in it.  For measurement; no path calls it and it is not counted
    in LAUNCHES."""
    with torch.cuda.device(dev):
        _launch("sniper_empty_launch", int(blocks), int(threads),
                torch.cuda.current_stream(dev).cuda_stream)
