"""Model tables: the host precompute and the device tensors.

Two parts.  The first is the port's own copy of
somatic_sniper_tpu/models/tables.py (``ModelParams``, ``ModelTables``,
``build_tables``: the bit-exact numpy precompute), whole; the port
imports nothing of the JAX package.  The second (``DeviceTables``, a
port of the JAX runner's DeviceTables) moves the tables to a device once
per ``(params, device)`` and derives the rank-weight table and the
per-depth cuts the kernels read.  Only that second part touches torch,
and imports it where a tensor is first made: the host precompute serves
the all-host exact run, which needs no torch at all.

Host-side precompute of the MAQ consensus-model tables.

Replicates, value-for-value, the startup tables of the reference caller:

* ``fk``    — rank-decay weights           (reference sniper_maqcns.c:70-73)
* ``coef``  — error-dependency coefficients (reference sniper_maqcns.c:59-100)
* ``lhet``  — heterozygote log-likelihoods  (reference sniper_maqcns.c:27-56)
* ``q_r``   — het penalty                   (reference sniper_maqcns.c:54-55)
* solo / joint genotype priors              (reference somatic_sniper.c:29-77)
* ``qAdd``  — phred-space logsumexp table   (reference somatic_sniper.c:101-107)

Bit-exactness notes:

* The reference stores ``theta``/``eta``/``het_rate`` as C ``float`` and
  promotes them to ``double`` inside the math; we mirror that with an
  explicit float32 round-trip.
* The inner loops of ``coef``/``lhet`` run in C ``long double`` (x87 80-bit
  on x86-64).  ``np.longdouble`` is the same type on this platform and numpy
  dispatches elementwise exp/log on it to ``expl``/``logl``, so the exact
  extended-precision rounding is reproduced.
* ``lgamma`` is taken from libm via ctypes (CPython's ``math.lgamma`` is a
  private reimplementation that can differ in the last ulp).

Tables are cached per parameter set; computing the full ``coef`` table
(64*256*256 doubles, 32 MiB) takes a few seconds, same as the reference's
startup cost.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
import threading

import numpy as np

from ..constants import (GLF_BASE, IS_HET, IS_HOM, PHRED_CONST,
                         THETA_POP, log_phred)

_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.lgamma.restype = ctypes.c_double
_libm.lgamma.argtypes = [ctypes.c_double]


def _lgamma(x: float) -> float:
    """glibc lgamma (double), as used by the reference."""
    return _libm.lgamma(float(x))


@functools.lru_cache(maxsize=None)
def _lgamma_vec(n: int) -> np.ndarray:
    """lgamma(0+1 .. n-1+1) as a float64 vector."""
    return np.array([_lgamma(i + 1.0) for i in range(n)], dtype=np.float64)


def _f32(x: float) -> float:
    """Round a python float through IEEE float32, like C float storage."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=8)
def compute_fk(theta: float, eta: float) -> tuple[np.ndarray, np.ndarray]:
    """fk[n] = theta^n*(1-eta)+eta; fk2[n] = fk[n>>1].

    reference sniper_maqcns.c:70-73.  ``theta``/``eta`` go through float32
    storage first (struct fields are C float).
    """
    theta_d = _f32(theta)
    eta_d = _f32(eta)
    fk = np.empty(256, dtype=np.float64)
    fk[0] = 1.0
    for n in range(1, 256):
        fk[n] = math.pow(theta_d, n) * (1.0 - eta_d) + eta_d
    fk2 = fk[np.arange(256) >> 1].copy()
    fk2[0] = 1.0
    return fk, fk2


@functools.lru_cache(maxsize=4)
def compute_coef(theta: float, eta: float) -> np.ndarray:
    """coef[q, n, k] error-dependency table (reference sniper_maqcns.c:59-100).

    Inner recurrences run in long double exactly as in C; the result is
    rounded to float64 on store.
    """
    _, fk2 = compute_fk(theta, eta)
    fk2_ld = fk2.astype(np.longdouble)
    coef = np.zeros((64, 256, 256), dtype=np.float64)

    lgam = _lgamma_vec(257)  # lgamma(1..257)

    with np.errstate(divide="ignore", invalid="ignore"):
        for q in range(1, 64):
            e = math.pow(10.0, -q / 10.0)
            le = math.log(e)
            le1 = math.log(1.0 - e)
            for n in range(1, 256):
                ks = np.arange(n + 1)
                # lC[n,k] = lgamma(n+1)-lgamma(k+1)-lgamma(n-k+1)  (double)
                lC = lgam[n] - lgam[ks] - lgam[n - ks]
                # a_k terms, exp in long double of a double argument
                args = (lC + ks * le + (n - ks) * le1).astype(np.float64)
                terms = np.exp(args.astype(np.longdouble))
                # sum_a[k] = sum_{i>=k} term_i, sequential from high k (ld)
                sum_a = np.zeros(n + 2, dtype=np.longdouble)
                sum_a[: n + 1] = np.cumsum(terms[::-1])[::-1]
                b = sum_a[1 : n + 2] / sum_a[: n + 1]  # b[k], k=0..n
                b = np.minimum(b, np.longdouble(0.99))
                # q_c[k] = (-4.343 * fk2[k]) * logl(b[k]/e), k=0..n-1
                q_c = (np.float64(-PHRED_CONST) * fk2_ld[:n]) * np.log(b[:n] / e)
                q_c = np.cumsum(q_c)  # prefix products of c_i (ld, sequential)
                # tmp[k] = -4.343*logl(1-expl(fk2[k]*logl(b[k]))), k=0..n
                tmp = np.float64(-PHRED_CONST) * np.log(
                    np.longdouble(1.0) - np.exp(fk2_ld[: n + 1] * np.log(b))
                )
                row = np.empty(n + 1, dtype=np.longdouble)
                row[0] = tmp[0]
                row[1:] = q_c + tmp[1:]
                coef[q, n, : n + 1] = row.astype(np.float64)
    return coef


@functools.lru_cache(maxsize=8)
def compute_lhet(het_rate: float, n_hap: int) -> tuple[np.ndarray, float]:
    """lhet[n1,n2] table and q_r (reference sniper_maqcns.c:27-56).

    Returns (lhet float64[256,256], q_r) where q_r is the float32-stored
    het penalty.
    """
    het_rate_d = _f32(het_rate)
    sum_harmo = 0.0
    for k in range(1, n_hap):
        sum_harmo += 1.0 / k

    lgam = _lgamma_vec(512)
    n1 = np.arange(256)
    # lC[n1,n2] (double)
    lC = lgam[n1[:, None] + n1[None, :]] - lgam[n1][:, None] - lgam[n1][None, :]

    s = np.zeros((256, 256), dtype=np.longdouble)
    for k in range(1, n_hap):
        pk = 1.0 / k / sum_harmo
        log1 = math.log(float(k) / n_hap)
        log2 = math.log(1.0 - float(k) / n_hap)
        # expl of double arguments log1*n2, log2*n1 etc.
        e1n2 = np.exp((log1 * n1).astype(np.longdouble))  # expl(log1*n)
        e2n1 = np.exp((log2 * n1).astype(np.longdouble))
        e1n1 = np.exp((log1 * n1).astype(np.longdouble))
        e2n2 = np.exp((log2 * n1).astype(np.longdouble))
        s += (pk * 0.5) * (
            e1n2[None, :] * e2n1[:, None] + e1n1[:, None] * e2n2[None, :]
        )
    with np.errstate(divide="ignore"):
        lhet = (lC.astype(np.longdouble) + np.log(s)).astype(np.float64)

    poly_rate = het_rate_d * sum_harmo
    q_r = _f32(-PHRED_CONST * math.log(2.0 * poly_rate / (1.0 - poly_rate)))
    return lhet, q_r


@functools.lru_cache(maxsize=4)
def compute_solo_prior() -> np.ndarray:
    """prior[ref16, genotype10] (reference somatic_sniper.c:29-45)."""
    prior = np.zeros((16, 10), dtype=np.int32)
    for ref in range(16):
        for i in range(10):
            b = int(GLF_BASE[i])
            if not (b & ~ref):
                prior[ref, i] = 0
            elif b & ref:
                prior[ref, i] = log_phred(THETA_POP)
            elif IS_HOM[b]:
                prior[ref, i] = log_phred(0.5 * THETA_POP)
            else:
                prior[ref, i] = log_phred(THETA_POP * THETA_POP)
    return prior


@functools.lru_cache(maxsize=8)
def compute_joint_prior(somatic_rate: float) -> np.ndarray:
    """jointprior[ref16, normal10, tumor10] (reference somatic_sniper.c:47-77).

    Quirk preserved: the reference tests ``isHet[j] || isHom[j]`` with
    ``j`` being the tumor genotype INDEX (0..9) into the 16-entry
    base-code-indexed tables (somatic_sniper.c:66-68) — so for tumor
    genotypes AA (j=0) and GG (j=7) the shared-allele branch never
    fires and the transition pays the somatic_rate^2 penalty even when
    normal and tumor share an allele.  (Both index-quirk branches add
    logPhred(somatic_rate), and both fall-through branches add the
    squared term, so the indexes are the only observable effect.)
    """
    jp = np.zeros((16, 10, 10), dtype=np.int32)
    lp_som = log_phred(somatic_rate)
    lp_som2 = log_phred(somatic_rate * somatic_rate)
    for ref in range(16):
        for i in range(10):
            b = int(GLF_BASE[i])
            if not (b & ~ref):
                germ = 0
            elif b & ref:
                germ = log_phred(THETA_POP)
            elif IS_HOM[b]:
                germ = log_phred(0.5 * THETA_POP)
            else:
                germ = log_phred(THETA_POP * THETA_POP)
            for j in range(10):
                c = int(GLF_BASE[j])
                if b == c:
                    jp[ref, i, j] = germ
                elif (b & c) and (IS_HET[j] or IS_HOM[j]):
                    jp[ref, i, j] = germ + lp_som
                else:
                    jp[ref, i, j] = germ + lp_som2
    return jp


@functools.lru_cache(maxsize=1)
def compute_qadd_table() -> np.ndarray:
    """qAddTable[1024] (reference somatic_sniper.c:101-107).

    Entries 1000..1023 stay zero exactly like the reference's static array.
    """
    t = np.zeros(1024, dtype=np.int32)
    for i in range(1000):
        e = 1.0 + math.exp(-(float(i - 512)) / PHRED_CONST)
        t[i] = log_phred(e)
    return t


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """User-settable model parameters (reference main.c:70-99 defaults)."""

    theta: float = 0.85          # -T  (maq consensus theta)
    n_hap: int = 2               # -N
    het_rate: float = 0.001      # -r
    eta: float = 0.03
    cap_mapq: int = 60
    use_priors: bool = True      # not -p
    use_joint_priors: bool = False  # -J / -s
    somatic_mutation_rate: float = 0.01  # -s
    min_somatic_qual: int = 15   # -Q
    include_loh: bool = True     # not -L
    include_gor: bool = True     # not -G
    mapq_threshold: int = 0      # -q
    flag_mask: int = 0x704       # BAM_DEF_MASK


@dataclasses.dataclass(frozen=True)
class ModelTables:
    """All precomputed tables for one ``ModelParams``, as host numpy arrays."""

    fk: np.ndarray          # [256] f64
    coef: np.ndarray        # [64,256,256] f64
    lhet: np.ndarray        # [256,256] f64
    q_r: float              # float32-stored het penalty
    q_r_int: int            # (int)(q_r + 0.5) as used by glf2cns
    solo_prior: np.ndarray  # [16,10] i32
    joint_prior: np.ndarray  # [16,10,10] i32
    qadd: np.ndarray        # [1024] i32
    params: ModelParams


@functools.lru_cache(maxsize=4)
def build_tables(params: ModelParams = ModelParams()) -> ModelTables:
    fk, _ = compute_fk(params.theta, params.eta)
    coef = compute_coef(params.theta, params.eta)
    lhet, q_r = compute_lhet(params.het_rate, params.n_hap)
    if params.use_priors:
        solo = compute_solo_prior()
    else:
        solo = np.zeros((16, 10), dtype=np.int32)
    joint = compute_joint_prior(params.somatic_mutation_rate)
    return ModelTables(
        fk=fk,
        coef=coef,
        lhet=lhet,
        q_r=q_r,
        q_r_int=int(q_r + 0.5),
        solo_prior=solo,
        joint_prior=joint,
        qadd=compute_qadd_table(),
        params=params,
    )


# --- device tables ---

MAX_W = 255  # highest fk rank the reference's w[k] counter reaches


def fk_weights_f32(theta: float, eta: float) -> np.ndarray:
    """The 256-entry f32 rank-weight table ``theta^r*(1-eta)+eta``.

    Same f32 formula as the JAX fast path's in-register weights
    (somatic_sniper_tpu/models/glfgen.py:268-275), evaluated once on the
    host: the kernel and its plain version then read identical weights,
    where three ``exp`` implementations (XLA, torch, CUDA) would each
    differ by a few ulps."""
    theta32 = np.float32(theta)
    eta32 = np.float32(eta)
    log_theta = (np.float32(np.log(np.float64(theta32))) if theta32 > 0
                 else np.float32(-1e30))
    r = np.arange(MAX_W + 1, dtype=np.float32)
    return (np.exp(r * log_theta) * (np.float32(1.0) - eta32)
            + eta32).astype(np.float32)


class DeviceTables:
    """Model tables resident on one device, converted once per precision
    (somatic_sniper_tpu/runner.py:163-180).

    Fast: f32 coef/lhet, the f32 rank-weight table and per-slab-depth
    cuts for the assembly kernel; the f64 fk has no fast reader (the
    weight table replaces it).  Exact: ``fk``, ``coef`` and ``lhet`` as
    float64, read by the f64 glfgen.  Both: the i32 priors.  The qAdd
    table has no device reader (models.consensus.make_qadd is its closed
    form)."""

    def __init__(self, tabs: ModelTables, device: torch.device,
                 precision: str = "fast"):
        import torch

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        if precision not in ("fast", "exact"):
            raise ValueError(f"precision: {precision!r}")
        f = torch.float64 if precision == "exact" else torch.float32
        self.params = tabs.params
        self.precision = precision
        self.coef = put(tabs.coef, f)
        self.lhet = put(tabs.lhet, f)
        self.solo_prior = put(tabs.solo_prior, torch.int32)
        self.joint_prior = put(tabs.joint_prior, torch.int32)
        self.q_r_int = int(tabs.q_r_int)
        if precision == "exact":
            self.fk = put(tabs.fk, f)
        else:
            self.fk_weights = put(
                fk_weights_f32(tabs.params.theta, tabs.params.eta), f)
        self._subs: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._lock = threading.Lock()

    def assembly_tables(self, D: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(``coef[4:64, :NK, :NK]``, ``lhet[:NK, :NK]``), contiguous,
        with NK = min(D, 255) + 1 (glfgen.py:633).

        Every index the assembly forms is bounded by the batch depth:
        bar_e in [4, 63], c_tot and the others-counts <= D; deeper
        batches rescale their counts to c_tot <= 256 first and read the
        full tables."""
        nk = min(D, 255) + 1
        with self._lock:
            sub = self._subs.get(nk)
            if sub is None:
                sub = (self.coef[4:64, :nk, :nk].contiguous(),
                       self.lhet[:nk, :nk].contiguous())
                self._subs[nk] = sub
            return sub


@functools.lru_cache(maxsize=8)
def _device_tables(params: ModelParams, device: torch.device,
                   precision: str) -> DeviceTables:
    return DeviceTables(build_tables(params), device, precision)


def device_tables(tabs: ModelTables, device,
                  precision: str = "fast") -> DeviceTables:
    """Process-wide DeviceTables cache keyed by ``(params, device,
    precision)``: the coef upload (16 MiB in f32, 32 MiB in f64) is paid
    once, not once per run."""
    import torch

    return _device_tables(tabs.params, torch.device(device), precision)
