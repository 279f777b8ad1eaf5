"""SomaticSniper's statistics in plain numpy: the MAQ likelihoods, the
consensus calls, the somatic score, the gates and the dqstats.

Written from the tool's C sources as SURVEY.md cites them:
sniper_maqcns.c:27-100 (tables), :127-248 (glfgen), :250-282
(glf2cns); somatic_sniper.c:29-107 (priors, qAdd), :109-273
(glf_somatic); allele_util.c; dqstats.c:6-53.  The C arithmetic is
kept: float accumulators updated through double operations, double
table reads, ``(int)(x + .5)`` rounding, long-double table loops
(numpy's longdouble is x87 extended precision on x86-64), and glibc's
``lgamma``.  Columns are scored in blocks of equal padded depth, one
vectorised step per rank.

``precision="bf16"`` is the control: the same model with every
floating table, sum, product and stored float rounded to bfloat16.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from dataclasses import dataclass

import numpy as np

PHRED = 4.343
THETA_POP = 0.001
# 4-bit allele set of each of the ten genotypes, in likelihood order
GLF_BASE = np.array([1, 3, 5, 9, 2, 6, 10, 4, 12, 8], np.int64)
PAIRS = [(j, k) for j in range(4) for k in range(j, 4)]
HOM_SLOTS = (0, 4, 7, 9)
IS_HOM16 = np.array([0, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0])
IS_HET16 = np.array([0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 0])
NT4 = np.array([4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4], np.int64)
WILDTYPE, GERMLINE, SOMATIC, LOH, UNKNOWN = range(5)

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.lgamma.restype = ctypes.c_double
_libm.lgamma.argtypes = [ctypes.c_double]


def bf16(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def log_phred(x: float) -> int:
    return int((0.5 - PHRED * math.log(x)) if x < 1
               else (-0.5 - PHRED * math.log(x)))


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class Params:
    theta: float = 0.85
    n_hap: int = 2
    het_rate: float = 0.001
    eta: float = 0.03
    cap_mapq: int = 60
    priors: bool = True
    joint: bool = False
    somatic_rate: float = 0.01
    min_qual: int = 15
    no_loh: bool = False
    no_gor: bool = False
    mapq_min: int = 0
    flag_mask: int = 0x704


def params_from_flags(flags: list) -> Params:
    """bam-somaticsniper's short flags, read by the tool's own rules
    (main.c:80-99; ``-s`` implies ``-J``)."""
    kw, i = {}, 0
    value = {"-q": ("mapq_min", int), "-Q": ("min_qual", int),
             "-s": ("somatic_rate", float), "-T": ("theta", float),
             "-N": ("n_hap", int), "-r": ("het_rate", float)}
    switch = {"-L": ("no_loh", True), "-G": ("no_gor", True),
              "-p": ("priors", False), "-J": ("joint", True)}
    while i < len(flags):
        f = flags[i]
        if f in value:
            name, typ = value[f]
            kw[name] = typ(flags[i + 1])
            if f == "-s":
                kw["joint"] = True
            i += 2
        elif f in switch:
            kw[switch[f][0]] = switch[f][1]
            i += 1
        elif f in ("-F", "-n", "-t"):
            i += 2
        else:
            raise ValueError(f"flag the reference does not read: {f}")
    return Params(**kw)


@dataclass(frozen=True)
class Tables:
    fk: np.ndarray       # [256] f64
    coef: np.ndarray     # [64, 256, 256] f64
    lhet: np.ndarray     # [256, 256] f64
    q_r: int             # (int)(het penalty + .5)
    solo: np.ndarray     # [16, 10]
    joint: np.ndarray    # [16, 10, 10]
    qadd: np.ndarray     # [1024]


def _lgam(n: int) -> np.ndarray:
    return np.array([_libm.lgamma(i + 1.0) for i in range(n)], np.float64)


def _prior(ref: int, b: int) -> int:
    if not (b & ~ref):
        return 0
    if b & ref:
        return log_phred(THETA_POP)
    if IS_HOM16[b]:
        return log_phred(0.5 * THETA_POP)
    return log_phred(THETA_POP * THETA_POP)


@functools.lru_cache(maxsize=4)
def tables(p: Params) -> Tables:
    theta, eta = _f32(p.theta), _f32(p.eta)
    fk = np.array([1.0] + [math.pow(theta, n) * (1.0 - eta) + eta
                           for n in range(1, 256)])
    fk2 = fk[np.arange(256) >> 1].copy()
    fk2[0] = 1.0
    fk2l = fk2.astype(np.longdouble)
    lg = _lgam(512)
    ld = np.longdouble
    coef = np.zeros((64, 256, 256))
    with np.errstate(divide="ignore", invalid="ignore"):
        for q in range(1, 64):
            e = math.pow(10.0, -q / 10.0)
            le, le1 = math.log(e), math.log(1.0 - e)
            for n in range(1, 256):
                k = np.arange(n + 1)
                lc = lg[n] - lg[k] - lg[n - k]
                terms = np.exp((lc + k * le + (n - k) * le1).astype(ld))
                tail = np.zeros(n + 2, ld)
                tail[:n + 1] = np.cumsum(terms[::-1])[::-1]
                b = np.minimum(tail[1:] / tail[:-1], ld(0.99))
                qc = np.cumsum((np.float64(-PHRED) * fk2l[:n]) * np.log(b[:n] / e))
                t = np.float64(-PHRED) * np.log(
                    ld(1.0) - np.exp(fk2l[:n + 1] * np.log(b)))
                coef[q, n, 0] = t[0]
                coef[q, n, 1:n + 1] = (qc + t[1:]).astype(np.float64)
        hr = _f32(p.het_rate)
        harmo = sum(1.0 / k for k in range(1, p.n_hap))
        n1 = np.arange(256)
        lc = lg[n1[:, None] + n1[None, :]] - lg[n1][:, None] - lg[n1][None, :]
        s = np.zeros((256, 256), ld)
        for k in range(1, p.n_hap):
            pk = 1.0 / k / harmo
            a = np.exp((math.log(float(k) / p.n_hap) * n1).astype(ld))
            c = np.exp((math.log(1.0 - float(k) / p.n_hap) * n1).astype(ld))
            s += (pk * 0.5) * (a[None, :] * c[:, None] + a[:, None] * c[None, :])
        lhet = (lc.astype(ld) + np.log(s)).astype(np.float64)
    poly = hr * harmo
    q_r = _f32(-PHRED * math.log(2.0 * poly / (1.0 - poly)))
    solo = np.zeros((16, 10), np.int64)
    joint = np.zeros((16, 10, 10), np.int64)
    ls, ls2 = log_phred(p.somatic_rate), log_phred(p.somatic_rate ** 2)
    for ref in range(16):
        for i in range(10):
            b = int(GLF_BASE[i])
            g = _prior(ref, b)
            if p.priors:
                solo[ref, i] = g
            for j in range(10):
                c = int(GLF_BASE[j])
                # the tool tests isHet/isHom at the genotype's INDEX j
                # (somatic_sniper.c:66-68), not at its allele set
                if b == c:
                    joint[ref, i, j] = g
                elif (b & c) and (IS_HET16[j] or IS_HOM16[j]):
                    joint[ref, i, j] = g + ls
                else:
                    joint[ref, i, j] = g + ls2
    qadd = np.zeros(1024, np.int64)
    for i in range(1000):
        qadd[i] = log_phred(1.0 + math.exp(-float(i - 512) / PHRED))
    return Tables(fk, coef, lhet, int(q_r + 0.5), solo, joint, qadd)


def _trunc_half(x):
    return np.floor(x + 0.5).astype(np.int64)


def glfgen(base, bq, mq, strand, n, ref16, tab: Tables, cap_mapq: int,
           precision: str = "exact"):
    """Ten phred likelihoods [C, 10] of C columns of kept (non-deleted)
    entries, padded to a common depth D: ``base`` etc. [C, D], the first
    ``n[c]`` lanes of row c live."""
    f32 = np.float32
    low = precision == "bf16"
    rnd = bf16 if low else (lambda v: np.asarray(v, f32))
    # in bfloat16 every product and sum is rounded, not only the stores
    op = bf16 if low else (lambda v: v)
    fk = tab.fk if precision == "exact" else bf16(tab.fk).astype(np.float64)
    C, D = base.shape
    live = np.arange(D)[None, :] < n[:, None]
    code = np.where(base != 0, base, ref16[:, None])
    b2 = NT4[code]
    x = (strand << 18) | (bq << 8) | mq | (np.minimum(bq, mq) << 24)
    x = np.where(b2 < 4, x | (1 << 21) | (b2 << 16), x)
    x = np.sort(np.where(live, x, 0xFFFFFFFF), axis=1)
    esum = np.zeros((C, 4), f32)
    fsum = np.zeros((C, 4), f32)
    cnt = np.zeros((C, 4), np.int64)
    w = np.zeros((C, 8), np.int64)
    rows = np.arange(C)
    for t in range(D):   # highest key first: it takes fk[0] in its class
        j = n - 1 - t
        alive = j >= 0
        info = x[rows, np.maximum(j, 0)]
        eq = info >> 24
        eq = np.where((eq < 4) & (((info >> 8) & 0x3F) != 0), 4, eq)
        k8 = (info >> 16) & 7
        k4 = k8 & 3
        upd = alive & (eq > 0)
        r, kk, k8u = rows[upd], k4[upd], k8[upd]
        fkw = fk[np.minimum(w[r, k8u], 255)]
        esum[r, kk] = rnd(esum[r, kk].astype(np.float64) + op(fkw * eq[upd]))
        fsum[r, kk] = rnd(fsum[r, kk].astype(np.float64) + fkw)
        cnt[r, kk] += 1
        w[r, k8u] += w[r, k8u] < 255
    coef, lhet = tab.coef, tab.lhet
    if precision != "exact":
        coef, lhet = bf16(coef).astype(np.float64), bf16(lhet).astype(np.float64)
    ctot = cnt.sum(1)
    big = ctot > 255
    if big.any():   # depth rescale (sniper_maqcns.c:178-182)
        cnt[big] = _trunc_half(254.0 * cnt[big] / ctot[big, None])
        ctot[big] = cnt[big].sum(1)
    ctot = np.minimum(ctot, 255)

    def others(v, ex):
        s = np.zeros(C, v.dtype)
        for k in range(4):
            if k not in ex:
                s = s + v[:, k]
                if v.dtype == f32:
                    s = op(s)
        return s

    p = np.zeros((C, 4, 4), f32)
    for j, k in PAIRS:
        ex = (j,) if j == k else (j, k)
        t1, t3, t2 = others(esum, ex), others(fsum, ex), others(cnt, ex)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(t2 > 0, op(t1 / np.where(t3 == 0, 1, t3)), 0)
        be = np.clip(_trunc_half(ratio.astype(np.float64)), 4, 63)
        cf = coef[be, ctot, np.minimum(t2, 255)]
        if j == k:
            v = np.where(t2 > 0, rnd(t1.astype(np.float64) + op(cf)), 0)
            p[:, j, j] = v
        else:
            lh = op(-PHRED * lhet[cnt[:, j].clip(0, 255), cnt[:, k].clip(0, 255)])
            v = np.where(t2 > 0, rnd(op(lh + t1.astype(np.float64)) + cf),
                         rnd(lh))
            p[:, j, k] = v
            p[:, k, j] = v
    p = np.maximum(p, f32(0))
    # best-base fix of p[k][k] (sniper_maqcns.c:216-233), C scan ties
    max1 = np.full(C, -1.0, f32)
    max2 = np.full(C, -1.0, f32)
    maxk = np.full(C, -1)
    min1 = np.full(C, 1e30, f32)
    min2 = np.full(C, 1e30, f32)
    mink = np.full(C, -1)
    for k in range(4):
        e = esum[:, k]
        g1 = e > max1
        g2 = ~g1 & (e > max2)
        max2 = np.where(g1, max1, np.where(g2, e, max2))
        max1 = np.where(g1, e, max1)
        maxk = np.where(g1, k, maxk)
        d = p[:, k, k]
        l1 = d < min1
        l2 = ~l1 & (d < min2)
        min2 = np.where(l1, min1, np.where(l2, d, min2))
        min1 = np.where(l1, d, min1)
        mink = np.where(l1, k, mink)
    m1 = min1.astype(np.float64)
    fix = (max1 > max2) & ((mink != maxk) | (m1 + 1.0 > min2.astype(np.float64)))
    val = np.where(m1 > 1.0, rnd(m1 - 1.0), f32(0))
    fr = np.flatnonzero(fix)
    p[fr, maxk[fr], maxk[fr]] = val[fr]
    p10 = np.stack([p[:, j, k] for j, k in PAIRS], 1)
    mn = p10.min(1)
    d = op(p10 - mn[:, None]).astype(np.float64)
    lk = np.where(d > 255.0, 255, _trunc_half(d))
    return np.where((n > 0)[:, None], lk, 0)


def glf2cns(lk, n_raw, q_r: int):
    """Best and second genotype and their qualities (sniper_glf2cns)."""
    pen = np.ones(10, np.int64)
    pen[list(HOM_SLOTS)] = 0
    t = lk + pen * q_r
    order = np.argsort(t, axis=1, kind="stable")
    srt = np.take_along_axis(t, order, 1)
    b1, b2 = GLF_BASE[order[:, 0]], GLF_BASE[order[:, 1]]
    q1 = np.minimum(srt[:, 1] - srt[:, 0], 255)
    q2 = np.minimum(srt[:, 2] - srt[:, 1], 255)
    z = n_raw == 0
    return (np.where(z, 15, b1), np.where(z, 15, b2), np.where(z, 0, q1),
            np.where(z, 0, q2))


def _qadd(tab, x, y):
    return x + tab.qadd[np.clip(512 + y - x, 0, 1023)]


def somatic_score(lk_t, lk_n, ref16, tab: Tables, joint: bool):
    """(score, joint tumor gt, joint normal gt, joint quality)."""
    C = len(ref16)
    if not joint:
        def post(lk):
            x = lk + tab.solo[ref16]
            s = np.full(C, 255)
            for j in range(10):
                s = _qadd(tab, x[:, j], s)
            return np.minimum(x - s[:, None], 255)

        pt, pn = post(lk_t), post(lk_n)
        q = np.full(C, 255)
        for j in range(10):
            q = _qadd(tab, q, pt[:, j] + pn[:, j])
        z = np.zeros(C, np.int64)
        return q, z, z, np.full(C, 255)
    jl = np.minimum(lk_n[:, :, None] + lk_t[:, None, :] + tab.joint[ref16], 255)
    flat = jl.reshape(C, 100)
    best = flat.argmin(1)
    ni, tj = best // 10, best % 10
    marg = np.full(C, 255)
    for t in range(100):
        marg = _qadd(tab, marg, flat[:, t])
    q = np.full(C, 255)
    jq = np.full(C, 255)
    for j in range(10):
        v = jl[:, j, j] - marg
        q = _qadd(tab, q, v)
        # the stale loop index of somatic_sniper.c:193-199 leaves only
        # the tumor test
        jq = np.where(j != tj, _qadd(tab, jq, v), jq)
    return q, GLF_BASE[tj], GLF_BASE[ni], np.minimum(jq, 255)


def proper_subset(a, b):
    return (b != a) & ((a & b) == a)


def dqstats(base, bq, mq, strand, n, rb4, wanted):
    """[C, 18]: mean base qualities, mean mapping qualities, base counts,
    DP4, depth, mean mapping quality (dqstats.c:6-53), over the kept
    lanes; a '=' base (0) counts for every allele, as in the tool."""
    live = np.arange(base.shape[1])[None, :] < n[:, None]
    is_ref = live & (base == rb4[:, None])
    not_ref = live & (base != rb4[:, None])
    dp4 = [(m & (strand == s)).sum(1) for m in (is_ref, not_ref) for s in (0, 1)]

    def mean(s, o):
        return np.where(o > 0, (s / np.maximum(o, 1) + 0.499).astype(np.int64), 0)

    occ, mb, mm = [], [], []
    for j in range(4):
        v = 1 << j
        m = live & ((base & v) == base)
        o = m.sum(1)
        want = (wanted & v) != 0
        occ.append(o)
        mb.append(mean(np.where(want, (bq * m).sum(1), 0), o))
        mm.append(mean(np.where(want, (mq * m).sum(1), 0), o))
    tot = mean((mq * live).sum(1), n)
    return np.stack(mb + mm + occ + dp4 + [n, tot], 1)
