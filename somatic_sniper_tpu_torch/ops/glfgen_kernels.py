"""The glfgen kernels: CUDA wrappers, their plain torch versions, and
launch counters.

``accumulate32`` and ``assembly10`` replace the Pallas kernels of the
same names in somatic_sniper_tpu/ops/pallas_glfgen.py (sources in
``csrc/``).  Each wrapper checks its inputs, then

* for tensors on the CPU, runs the plain torch version;
* for CUDA tensors, launches the kernel on the current stream and
  counts the launch in :data:`LAUNCHES` — or raises.  There is no
  fallback from the card to the plain version.

Slot words cross into torch as int32: their bits stay below 2^21
(``mapQ | baseQ<<8 | base16<<16 | strand<<20``).
"""

from __future__ import annotations

import torch

from ..models.tables import MAX_W

F32 = torch.float32
I32 = torch.int32
MAX_D = 255  # depth bound of the packed slab metadata

# kernel launches since the last reset_launches(); a wrapper adds one
# only where it launches its CUDA kernel
LAUNCHES = {"accumulate32": 0, "assembly10": 0}

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

def accumulate32_plain(slots, n_keep, ref16, weights, cap_mapq: int):
    """(esum f32[B,4], fsum f32[B,4], c i32[B,4], rms i32[B]) in torch ops.

    Follows somatic_sniper_tpu/models/glfgen.py _fast_accumulate
    (:201-288) over the raw kept-only lanes: one sort on the composite
    class-major, key-descending word, then the within-class rank of
    each entry as a cumsum minus the cumsum at its class start (gathers
    where the TPU used one-hot contractions)."""
    B, D = slots.shape
    dev = slots.device
    j_idx = torch.arange(D, device=dev)[None, :]
    alive0 = j_idx < n_keep[:, None]
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

    alive = j_idx < n_keep[:, None]
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
    return esum, fsum, c, rms


def accumulate32(slots, n_keep, ref16, weights, cap_mapq: int):
    """Rank-weighted class sums over raw kept-only slab lanes.

    ``slots`` i32[B, D] (D <= 255), ``n_keep``/``ref16`` i32[B],
    ``weights`` the f32[256] rank-weight table
    (models.tables.fk_weights_f32).  Returns (esum f32[B,4],
    fsum f32[B,4], c i32[B,4], rms i32[B]); c and rms are exact, the
    sums agree with the plain version to f32 summation order."""
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


# -- assembly10 ---------------------------------------------------------------

def _count_error(NK: int) -> str:
    return (f"class counts outside [0, {NK - 1}] or summing past the table "
            f"depth {NK - 1}: c must come from a slab of depth <= {NK - 1}")


def assembly10_plain(esum, fsum, c, n, coef_sub, lhet_sub):
    """(lk i32[B,10], min_lk i32[B]) in torch ops.

    Follows the XLA assembly of somatic_sniper_tpu/models/glfgen.py
    (:579-752) operation for operation in f32, with gathers in place of
    the one-hot contractions (a gather is an exact copy)."""
    B = esum.shape[0]
    NK = coef_sub.shape[1]
    dev = esum.device
    c_tot = c.sum(dim=1)
    if B and (int(c.min()) < 0 or int(c_tot.max()) > NK - 1):
        raise ValueError(_count_error(NK))
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
        cf = coef_flat[((be.long() - 4) * NK + c_tot) * NK + tmp2]
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


def assembly10(esum, fsum, c, n, coef_sub, lhet_sub):
    """The ten-genotype likelihood assembly.

    ``coef_sub`` is ``coef[4:64, :NK, :NK]`` f32 and ``lhet_sub``
    ``lhet[:NK, :NK]`` f32 with NK = D + 1 <= 256 for a slab of depth D,
    so the class totals (<= D) index inside the tables and the
    reference's c_tot > 255 rescale (glfgen.py:579-586) cannot apply.
    Counts outside that (a negative class count, or a total past NK - 1)
    raise ValueError on either device; on the card the kernel flags them
    and the wrapper waits for the flag.  Returns (lk i32[B,10],
    min_lk i32[B]), bit-identical to the plain version on the same
    inputs."""
    if esum.dim() != 2:
        raise ValueError(f"esum: expected [B, 4], got {tuple(esum.shape)}")
    B = esum.shape[0]
    dev = esum.device
    if coef_sub.dim() != 3:
        raise ValueError("coef_sub: expected [60, NK, NK]")
    NK = coef_sub.shape[1]
    if not 1 <= NK <= MAX_D + 1:
        raise ValueError(
            f"table depth NK={NK} outside [1, {MAX_D + 1}]: deeper slabs "
            "would need the c_tot > 255 rescale")
    _check("esum", esum, F32, (B, 4), dev)
    _check("fsum", fsum, F32, (B, 4), dev)
    _check("c", c, I32, (B, 4), dev)
    _check("n", n, I32, (B,), dev)
    _check("coef_sub", coef_sub, F32, (60, NK, NK), dev)
    _check("lhet_sub", lhet_sub, F32, (NK, NK), dev)
    if dev.type == "cpu":
        return assembly10_plain(esum, fsum, c, n, coef_sub, lhet_sub)
    if dev.type != "cuda":
        raise ValueError(f"assembly10: unsupported device {dev}")
    lk = torch.empty((B, 10), dtype=I32, device=dev)
    min_lk = torch.empty((B,), dtype=I32, device=dev)
    if B == 0:
        return lk, min_lk
    with torch.cuda.device(dev):
        err = torch.zeros(1, dtype=I32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("sniper_assembly10", _ptr(esum), _ptr(fsum), _ptr(c),
                _ptr(n), _ptr(coef_sub), _ptr(lhet_sub), _ptr(lk),
                _ptr(min_lk), _ptr(err), B, NK, stream)
        LAUNCHES["assembly10"] += 1
        # the kernel flags columns whose counts would index past the
        # tables (reading the flag waits for the kernel)
        if int(err.item()):
            raise ValueError(_count_error(NK))
    return lk, min_lk
