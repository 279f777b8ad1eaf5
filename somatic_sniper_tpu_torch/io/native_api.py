"""High-level wrappers over the native IO/pileup library.

Copy of somatic_sniper_tpu/io/native_api.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..constants import BAM_DEF_MASK
from ..pileup.columnize import ColumnarPileup
from .bam import BamHeader
from . import native

# deepest slab slab_fill_pair fills: its wide metadata layout keeps
# depths and kept counts in 16 bits (models.somatic.MAX_D)
SLAB_MAX_D = 0xFFFF


def available() -> bool:
    return native.available()


def _default_threads() -> int:
    return max(2, os.cpu_count() or 2)


def _flag_tail_args(flag_args):
    """ctypes tail for the *_flagged builders from (ref16_blob, ref_off,
    fk, gmin, margin), keeping the arrays alive via the returned refs."""
    ref16, ref_off, fk, gmin, margin = flag_args
    blob = np.ascontiguousarray(ref16, np.uint8)
    off = np.ascontiguousarray(ref_off, np.int64)
    fk_c = np.ascontiguousarray(fk, np.float64)
    gm_c = np.ascontiguousarray(gmin, np.float64)
    tail = (
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(off) - 1,
        fk_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gm_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(margin),
    )
    return tail, (blob, off, fk_c, gm_c)


def load_and_columnize(
    path: str,
    flag_mask: int = BAM_DEF_MASK,
    mapq_thresh: int = 0,
    n_threads: int | None = None,
    flag_args: tuple | None = None,
) -> tuple[BamHeader, ColumnarPileup]:
    """Native BGZF+BAM decode and pileup columnarization in one call.

    ``flag_args`` = (ref16_blob, ref_off, fk, gmin, margin) additionally
    computes the per-column pure-reference margin flags inside the load
    (they ride the per-file decode threads instead of the serial plan
    phase; consumed by the native paired_plan)."""
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    hd = lib.bam_read_header(path.encode())
    if not hd:
        raise IOError(f"{path}: {lib.sniper_last_error().decode()}")
    try:
        c = hd.contents
        names_blob = ctypes.string_at(c.ref_names, c.ref_names_len)
        ref_names = [
            n.decode() for n in names_blob.split(b"\x00") if n
        ]
        ref_lengths = list(
            np.ctypeslib.as_array(c.ref_len, shape=(c.n_ref,))
        ) if c.n_ref else []
        header = BamHeader(
            text=(c.text or b"").decode(),
            ref_names=ref_names,
            ref_lengths=[int(x) for x in ref_lengths],
        )
    finally:
        lib.bam_header_destroy(hd)
    # fused load: inflate -> record scan -> pileup straight off the
    # record bytes; no intermediate NativeBam arrays are materialized
    if flag_args is not None:
        tail, _keep = _flag_tail_args(flag_args)
    else:
        tail = (None, None, 0, None, None, 0.0)
    np_ = lib.bam_load_pileup(
        path.encode(), n_threads or _default_threads(), flag_mask,
        mapq_thresh, *tail,
    )
    if not np_:
        raise IOError(
            f"{path}: pileup build failed: "
            f"{lib.sniper_last_error().decode()}"
        )
    return header, _wrap_pileup(lib, np_)


def _wrap_pileup(lib, np_ptr) -> ColumnarPileup:
    owner = _PileupHandle(lib, np_ptr)
    pc = np_ptr.contents
    ne, nc = pc.n_entries, pc.n_cols
    if nc == 0:
        return ColumnarPileup(
            keys=None, slots=np.zeros(0, np.uint32),
            ukeys=np.zeros(0, np.int64), offsets=np.zeros(1, np.int64),
            owner=owner,
        )
    return ColumnarPileup(
        keys=None,
        slots=np.ctypeslib.as_array(pc.slots, shape=(ne,)),
        ukeys=np.ctypeslib.as_array(pc.ukeys, shape=(nc,)),
        offsets=np.ctypeslib.as_array(pc.offsets, shape=(nc + 1,)),
        owner=owner,
    )


def load_region_and_columnize(
    path: str,
    chunks: np.ndarray,
    tid: int,
    beg: int,
    end: int,
    flag_mask: int = BAM_DEF_MASK,
    mapq_thresh: int = 0,
    n_threads: int | None = None,
    drop_first_end_le: int = -1,
    flag_args: tuple | None = None,
) -> ColumnarPileup:
    """Index-based region load + windowed pileup (region sharding path).

    ``chunks``: [n, 2] int64 merged virtual-offset spans from
    io.bai.region_chunks.  Columns are clipped to [beg, end) so shard
    outputs concatenate without overlap (owner-computes per column).
    ``drop_first_end_le``: carried previous-contig last-read start for
    the contig-transition drop quirk (windows starting at position 0 of
    a non-first contig; reference sniper_pileup.c:216).
    """
    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ch = np.ascontiguousarray(np.asarray(chunks, np.int64).reshape(-1, 2))
    if flag_args is not None:
        tail, _keep = _flag_tail_args(flag_args)
    else:
        tail = (None, None, 0, None, None, 0.0)
    # fused region load (see bam_load_region_pileup): no intermediate
    # NativeBam arrays are materialized
    np_ = lib.bam_load_region_pileup(
        path.encode(),
        ch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ch), tid, beg, end, n_threads or _default_threads(),
        flag_mask, mapq_thresh, drop_first_end_le, *tail,
    )
    if not np_:
        raise IOError(
            f"{path}: region pileup build failed: "
            f"{lib.sniper_last_error().decode()}"
        )
    return _wrap_pileup(lib, np_)


class _PileupHandle:
    """Owns a NativePileup; frees it on GC; provides native dense padding."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self._ptr = ptr

    def pad(self, col_idx: np.ndarray, D: int) -> np.ndarray:
        B = len(col_idx)
        out = np.empty((B, D), np.uint32)
        ci = np.ascontiguousarray(col_idx, dtype=np.int64)
        self._lib.pileup_pad(
            self._ptr,
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, D,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return out

    def pad16(self, col_idx: np.ndarray, ref16: np.ndarray, D: int,
              cap_mapq: int):
        """(slots u16[B,D], n_keep i32[B], rms_sum i32[B]) compact padding
        for the device fast path (see pileup_pad16 in the native source)."""
        B = len(col_idx)
        out = np.empty((B, D), np.uint16)
        nk = np.empty(B, np.int32)
        rms = np.empty(B, np.int32)
        self.pad16_into(col_idx, ref16, D, cap_mapq, out, nk, rms)
        return out, nk, rms

    def pad16_into(self, col_idx: np.ndarray, ref16: np.ndarray, D: int,
                   cap_mapq: int, out: np.ndarray, nk: np.ndarray,
                   rms: np.ndarray) -> None:
        """pad16 writing into caller-provided contiguous views (lets the
        runner build the final device upload buffer with zero extra host
        copies — the padded [2,B,D] stack is written in place)."""
        B = len(col_idx)
        assert out.flags.c_contiguous and out.dtype == np.uint16
        assert nk.flags.c_contiguous and rms.flags.c_contiguous
        ci = np.ascontiguousarray(col_idx, dtype=np.int64)
        r16 = np.ascontiguousarray(ref16, dtype=np.int32)
        self._lib.pileup_pad16(
            self._ptr,
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r16.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            B, D, cap_mapq,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            nk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )

    def __del__(self):
        try:
            self._lib.pileup_destroy(self._ptr)
        except Exception:
            pass


class PairedPlan:
    """Output of :func:`paired_plan`: shared columns grouped by depth
    bucket (groups 0..len(buckets)-1), oversize columns in the final
    group.  Arrays are parallel; group g occupies
    ``[group_off[g], group_off[g+1])``."""

    __slots__ = ("keys", "ti", "ni", "d_t", "d_n", "ref16", "group_off")

    def __init__(self, keys, ti, ni, d_t, d_n, ref16, group_off):
        self.keys = keys
        self.ti = ti
        self.ni = ni
        self.d_t = d_t
        self.d_n = d_n
        self.ref16 = ref16
        self.group_off = group_off


def precomputed_pure(pu: ColumnarPileup) -> np.ndarray | None:
    """Zero-copy view of the load-time pure-reference flags, if the
    pileup was built with ``flag_args`` (else None)."""
    owner = pu.owner
    if owner is None or getattr(owner, "_ptr", None) is None:
        return None
    pc = owner._ptr.contents
    if not pc.pure:
        return None
    n = int(pc.n_cols)
    if n == 0:
        return np.zeros(0, np.uint8)
    return np.ctypeslib.as_array(pc.pure, shape=(n,))


def slab_fill_pair(
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    ti: np.ndarray,
    ni: np.ndarray,
    ref16: np.ndarray,
    d_t: np.ndarray,
    d_n: np.ndarray,
    D: int,
    cap_mapq: int,
    out_t: np.ndarray,
    out_n: np.ndarray,
    meta0: np.ndarray,
    meta1: np.ndarray,
    meta2: np.ndarray,
) -> None:
    """Fused dual-sample raw-lane copy + packed-metadata assembly into
    the caller's slab buffers (see slab_fill_pair in the native source;
    layout contract: models/somatic.py call_batch_packed raw32).  All
    output views must be C-contiguous."""
    if not 1 <= D <= SLAB_MAX_D:
        raise ValueError(f"slab depth D={D} outside [1, {SLAB_MAX_D}]: the "
                         "packed metadata holds depths in 16 bits")
    lib = pu_t.owner._lib
    B = len(ti)
    for a in (out_t, out_n, meta0, meta1, meta2):
        assert a.flags.c_contiguous, "slab views must be contiguous"
    assert out_t.dtype == np.uint32 and out_n.dtype == np.uint32
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ti_c = np.ascontiguousarray(ti, np.int64)
    ni_c = np.ascontiguousarray(ni, np.int64)
    r16_c = np.ascontiguousarray(ref16, np.int32)
    dt_c = np.ascontiguousarray(d_t, np.int32)
    dn_c = np.ascontiguousarray(d_n, np.int32)
    lib.slab_fill_pair(
        pu_t.owner._ptr, pu_n.owner._ptr,
        ti_c.ctypes.data_as(i64p), ni_c.ctypes.data_as(i64p),
        r16_c.ctypes.data_as(i32p), dt_c.ctypes.data_as(i32p),
        dn_c.ctypes.data_as(i32p), B, D, cap_mapq,
        out_t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        meta0.ctypes.data_as(i32p), meta1.ctypes.data_as(i32p),
        meta2.ctypes.data_as(i32p),
    )


def glf_cns(
    pu: ColumnarPileup,
    col_idx: np.ndarray,
    ref16: np.ndarray,
    coef: np.ndarray,
    lhet: np.ndarray,
    fk: np.ndarray,
    q_r_int: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(cns i32[B], keep i32[B]) exact per-column consensus via the
    native glf_exact_cns — test surface for the plan-time SNP-gate
    filter (must match the JAX exact path bit for bit)."""
    import ctypes as ct

    lib = pu.owner._lib
    ci = np.ascontiguousarray(col_idx, np.int64)
    r16 = np.ascontiguousarray(ref16, np.int32)
    coef_c = np.ascontiguousarray(coef, np.float64)
    lhet_c = np.ascontiguousarray(lhet, np.float64)
    fk_c = np.ascontiguousarray(fk, np.float64)
    B = len(ci)
    cns = np.empty(B, np.int32)
    keep = np.empty(B, np.int32)
    dp = ct.POINTER(ct.c_double)
    lib.glf_cns_batch(
        pu.owner._ptr,
        ci.ctypes.data_as(ct.POINTER(ct.c_int64)), B,
        r16.ctypes.data_as(ct.POINTER(ct.c_int32)),
        coef_c.ctypes.data_as(dp), lhet_c.ctypes.data_as(dp),
        fk_c.ctypes.data_as(dp), int(q_r_int),
        cns.ctypes.data_as(ct.POINTER(ct.c_int32)),
        keep.ctypes.data_as(ct.POINTER(ct.c_int32)),
    )
    return cns, keep


def glf_cns_proof(
    pu: ColumnarPileup,
    col_idx: np.ndarray,
    ref16: np.ndarray,
    coef: np.ndarray,
    lhet: np.ndarray,
    fk: np.ndarray,
    q_r_int: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(proven i32[B], keep i32[B]) near-pure hom-ref proof per column
    (tier 2a of the plan filter) — test surface for its soundness
    contract: proven columns must have glf_cns == ref code."""
    import ctypes as ct

    lib = pu.owner._lib
    ci = np.ascontiguousarray(col_idx, np.int64)
    r16 = np.ascontiguousarray(ref16, np.int32)
    coef_c = np.ascontiguousarray(coef, np.float64)
    lhet_c = np.ascontiguousarray(lhet, np.float64)
    fk_c = np.ascontiguousarray(fk, np.float64)
    B = len(ci)
    proven = np.empty(B, np.int32)
    keep = np.empty(B, np.int32)
    dp = ct.POINTER(ct.c_double)
    lib.glf_cns_proof_batch(
        pu.owner._ptr,
        ci.ctypes.data_as(ct.POINTER(ct.c_int64)), B,
        r16.ctypes.data_as(ct.POINTER(ct.c_int32)),
        coef_c.ctypes.data_as(dp), lhet_c.ctypes.data_as(dp),
        fk_c.ctypes.data_as(dp), int(q_r_int),
        proven.ctypes.data_as(ct.POINTER(ct.c_int32)),
        keep.ctypes.data_as(ct.POINTER(ct.c_int32)),
    )
    return proven, keep


def exact_pair_rows(
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    ti: np.ndarray,
    ni: np.ndarray,
    rb4: np.ndarray,
    tabs,
    use_joint: bool,
    min_somatic_qual: int,
    include_loh: bool,
    include_gor: bool,
) -> np.ndarray:
    """Native full exact-mode scoring for planned column pairs.

    Returns the emitted-rows matrix [count, 1 + len(COMPACT_FIELDS)]
    (same layout the device compaction produces: leading column is the
    plan index), computed entirely host-side in the exact f64/integer
    model — no device round trip.  See sniper_native.cpp
    exact_pair_rows.
    """
    import ctypes as ct

    lib = pu_t.owner._lib
    ti_c = np.ascontiguousarray(ti, np.int64)
    ni_c = np.ascontiguousarray(ni, np.int64)
    rb_c = np.ascontiguousarray(rb4, np.int32)
    B = len(ti_c)
    coef_c = np.ascontiguousarray(tabs.coef, np.float64)
    lhet_c = np.ascontiguousarray(tabs.lhet, np.float64)
    fk_c = np.ascontiguousarray(tabs.fk, np.float64)
    qadd_c = np.ascontiguousarray(tabs.qadd, np.int32)
    solo_c = np.ascontiguousarray(tabs.solo_prior, np.int32)
    joint_c = np.ascontiguousarray(tabs.joint_prior, np.int32)
    rows = np.empty((B, 17), np.int32)
    dp = ct.POINTER(ct.c_double)
    ip = ct.POINTER(ct.c_int32)
    count = lib.exact_pair_rows(
        pu_t.owner._ptr, pu_n.owner._ptr,
        ti_c.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ni_c.ctypes.data_as(ct.POINTER(ct.c_int64)), B,
        rb_c.ctypes.data_as(ip),
        coef_c.ctypes.data_as(dp), lhet_c.ctypes.data_as(dp),
        fk_c.ctypes.data_as(dp), int(tabs.q_r_int),
        qadd_c.ctypes.data_as(ip), solo_c.ctypes.data_as(ip),
        joint_c.ctypes.data_as(ip),
        int(use_joint), int(min_somatic_qual), int(include_loh),
        int(include_gor),
        rows.ctypes.data_as(ip),
    )
    return rows[:count]


_EMIT_FMT = {"classic": 0, "vcf": 1, "bed": 2}


def emit_lines(
    fmt: str,
    ref_names: list[str],
    tids: np.ndarray,
    poss: np.ndarray,
    chars: np.ndarray,
    rb4: np.ndarray,
    fields: np.ndarray,
    rows_t: np.ndarray,
    rows_n: np.ndarray,
    initial_cap: int | None = None,
) -> list[str] | None:
    """Bulk native text emission (sniper_native.cpp emit_lines): render
    all K output lines for ``fmt`` in one C pass, byte-identical to
    output/fast_emit.py's Python builders (which remain the readable
    reference and the fallback).  ``fields``: [K, NF] int64 in
    models.somatic.COMPACT_FIELDS order; ``rows_t``/``rows_n``: [K, 18]
    dqstats rows.  ``initial_cap`` overrides the first buffer size
    (tests use a tiny one to drive the grow-retry loop).  Returns None
    when the native library is unavailable.
    """
    import ctypes as ct

    lib = native.get_lib()
    if lib is None or fmt not in _EMIT_FMT:
        return None
    K = len(poss)
    if K == 0:
        return []
    name_bytes = [n.encode() for n in ref_names]
    blob = b"".join(name_bytes)
    off = np.zeros(len(name_bytes) + 1, np.int64)
    np.cumsum([len(b) for b in name_bytes], out=off[1:])
    tids_c = np.ascontiguousarray(tids, np.int64)
    poss_c = np.ascontiguousarray(poss, np.int64)
    chars_c = np.ascontiguousarray(chars, np.int32)
    rb_c = np.ascontiguousarray(rb4, np.int32)
    f_c = np.ascontiguousarray(fields, np.int64)
    rt_c = np.ascontiguousarray(rows_t, np.int32)
    rn_c = np.ascontiguousarray(rows_n, np.int32)
    line_off = np.empty(K + 1, np.int64)
    ip = ct.POINTER(ct.c_int32)
    lp = ct.POINTER(ct.c_int64)
    cap = int(initial_cap) if initial_cap else max(1 << 20, K * 420)
    while True:
        out = ct.create_string_buffer(cap)
        total = lib.emit_lines(
            _EMIT_FMT[fmt], K, blob, off.ctypes.data_as(lp),
            tids_c.ctypes.data_as(lp), poss_c.ctypes.data_as(lp),
            chars_c.ctypes.data_as(ip), rb_c.ctypes.data_as(ip),
            f_c.ctypes.data_as(lp), f_c.shape[1],
            rt_c.ctypes.data_as(ip), rn_c.ctypes.data_as(ip),
            out, cap, line_off.ctypes.data_as(lp),
        )
        if total >= 0:
            break
        cap *= 4
    try:
        # SAM restricts reference names to printable ASCII; a non-ASCII
        # name would round-trip differently through a UTF-8 text-mode
        # file than the Python builders' str path, so fall back to them
        # (None) rather than risk the bit-identity invariant
        buf = out.raw[:total].decode("ascii")
    except UnicodeDecodeError:
        return None
    offs = line_off.tolist()
    return [buf[offs[k]:offs[k + 1]] for k in range(K)]


def paired_plan(
    pu_t: ColumnarPileup,
    pu_n: ColumnarPileup,
    ref_blob: np.ndarray,
    ref_off: np.ndarray,
    buckets: tuple[int, ...],
    fk: np.ndarray | None = None,
    gmin: np.ndarray | None = None,
    margin: float = 0.0,
    coef: np.ndarray | None = None,
    lhet: np.ndarray | None = None,
    q_r_int: int = 0,
    cns_mode: str = "full",
) -> PairedPlan:
    """Fused native intersect + prefilter + depth-bucket grouping over
    two native pileups (one O(shared) C++ pass plus a threaded filter
    pass).  The margin-bound pure-reference prefilter runs iff ``gmin``
    is given; the exact dual-consensus filter (drop columns whose SNP
    gate provably fails under the reference's f64 model) additionally
    runs iff ``coef``/``lhet`` are given.  ``cns_mode="proof"`` keeps
    columns the cheap hom-ref proof cannot resolve instead of paying
    the full f64 eval (fast/device mode — the device applies the whole
    gate anyway)."""
    owner_t, owner_n = pu_t.owner, pu_n.owner
    lib = owner_t._lib
    blob = np.ascontiguousarray(ref_blob, np.uint8)
    off = np.ascontiguousarray(ref_off, np.int64)
    fk_c = np.ascontiguousarray(
        fk if fk is not None else np.zeros(256), np.float64
    )
    gmin_c = np.ascontiguousarray(
        gmin if gmin is not None else np.zeros(256), np.float64
    )
    bk = np.ascontiguousarray(buckets, np.int32)
    cap = int(min(len(pu_t.ukeys), len(pu_n.ukeys)))
    keys = np.empty(cap, np.int64)
    ti = np.empty(cap, np.int64)
    ni = np.empty(cap, np.int64)
    d_t = np.empty(cap, np.int32)
    d_n = np.empty(cap, np.int32)
    r16 = np.empty(cap, np.int32)
    goff = np.empty(len(bk) + 2, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dp = ctypes.POINTER(ctypes.c_double)
    use_cns = coef is not None and lhet is not None
    coef_c = (
        np.ascontiguousarray(coef, np.float64) if use_cns else np.zeros(1)
    )
    lhet_c = (
        np.ascontiguousarray(lhet, np.float64) if use_cns else np.zeros(1)
    )
    total = lib.paired_plan(
        owner_t._ptr, owner_n._ptr,
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        off.ctypes.data_as(i64p), len(off) - 1,
        fk_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        gmin_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(margin), 1 if gmin is not None else 0,
        coef_c.ctypes.data_as(dp), lhet_c.ctypes.data_as(dp),
        int(q_r_int),
        (2 if cns_mode == "proof" else 1) if use_cns else 0,
        bk.ctypes.data_as(i32p), len(bk),
        keys.ctypes.data_as(i64p), ti.ctypes.data_as(i64p),
        ni.ctypes.data_as(i64p), d_t.ctypes.data_as(i32p),
        d_n.ctypes.data_as(i32p), r16.ctypes.data_as(i32p),
        goff.ctypes.data_as(i64p),
    )
    assert int(goff[-1]) == int(total)
    return PairedPlan(keys[:total], ti[:total], ni[:total], d_t[:total],
                      d_n[:total], r16[:total], goff)
