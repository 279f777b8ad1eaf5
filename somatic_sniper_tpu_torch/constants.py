"""Shared constants of the somatic-sniper statistical model.

These mirror the tables and flag constants of the reference implementation
(see the reference sources: vendor samtools-0.1.6 ``bam.h``/``bam_import.c`` and
``src/lib/sniper/somatic_sniper.c``) but are re-derived here as numpy data for
a columnar, batched TPU pipeline.

Copy of somatic_sniper_tpu/constants.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# --- BAM flag bits (SAM spec; reference: vendor bam.h:96-121) ---
BAM_FPAIRED = 1
BAM_FPROPER_PAIR = 2
BAM_FUNMAP = 4
BAM_FMUNMAP = 8
BAM_FREVERSE = 16
BAM_FMREVERSE = 32
BAM_FREAD1 = 64
BAM_FREAD2 = 128
BAM_FSECONDARY = 256
BAM_FQCFAIL = 512
BAM_FDUP = 1024
# Default read-ingestion filter mask (vendor bam.h:121)
BAM_DEF_MASK = BAM_FUNMAP | BAM_FSECONDARY | BAM_FQCFAIL | BAM_FDUP

# --- CIGAR operations (vendor bam.h:128-148) ---
CIGAR_SHIFT = 4
CIGAR_MASK = 0xF
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD = range(7)
# NOTE: samtools-0.1.6 does not know about '='/'X' (ops 7/8); its CIGAR
# walkers ignore them entirely.  We replicate that behaviour for parity
# (reference resolve_cigar: sniper_pileup.c:57-104, bam_calend: bam.c:37-48).
REF_CONSUMING_OPS = (CMATCH, CDEL, CREF_SKIP)
QUERY_CONSUMING_OPS = (CMATCH, CINS, CSOFT_CLIP)

# --- Base encodings ---
# char -> 4-bit IUB code (A=1, C=2, G=4, T=8; '='->0; N and unknown ->15).
# Mirrors vendor bam_import.c:23-40.
NT16_TABLE = np.full(256, 15, dtype=np.uint8)
for _ch, _code in {
    "=": 0,
    "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6, "V": 7,
    "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12, "D": 13, "B": 14, "N": 15,
}.items():
    NT16_TABLE[ord(_ch)] = _code
    NT16_TABLE[ord(_ch.lower())] = _code
NT16_TABLE[ord("=")] = 0

# 4-bit IUB code -> character (vendor bam.c "=ACMGRSVTWYHKDBN")
NT16_REV_TABLE = "=ACMGRSVTWYHKDBN"

# 4-bit IUB -> 2-bit base index (A=0,C=1,G=2,T=3; ambiguous -> 4).
# Mirrors bam_nt16_nt4_table (reference sniper_maqcns.c:19).
NT16_NT4_TABLE = np.array(
    [4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4], dtype=np.uint8
)

# --- Diploid genotype encoding ---
# The 10 unordered diploid genotypes in likelihood order (upper-triangular
# (j,k), j<=k over bases A,C,G,T):  AA AC AG AT CC CG CT GG GT TT.
# glfBase maps each to its 4-bit allele-set code
# (reference somatic_sniper.c:26).
GLF_BASE = np.array([1, 3, 5, 9, 2, 6, 10, 4, 12, 8], dtype=np.int32)
# Homozygous / heterozygous predicates over 4-bit allele sets
# (reference somatic_sniper.c:24-25).
IS_HOM = np.array([0, 1, 1, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0], np.int32)
IS_HET = np.array([0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 0], np.int32)

# (j, k) base pairs for the 10 genotypes, in lk order.
GENOTYPE_PAIRS = [(j, k) for j in range(4) for k in range(j, 4)]

# Population-scaled mutation rate used by the somatic priors
# (reference somatic_sniper.c:14).
THETA_POP = 0.001

PHRED_CONST = 4.343

# Variant status codes (reference allele_util.h:14-20)
WILDTYPE, GERMLINE, SOMATIC, LOH, UNKNOWN = range(5)


def log_phred(x: float) -> int:
    """Integer phred transform, replicating the reference's logPhred macro.

    reference somatic_sniper.h:14:
    ``(int)((x) < 1 ? (0.5-4.343*log(x)) : (-0.5-4.343*log(x)))``
    (C float->int conversion truncates toward zero).
    """
    import math

    v = (0.5 - PHRED_CONST * math.log(x)) if x < 1 else (-0.5 - PHRED_CONST * math.log(x))
    return int(v)  # Python int() on float truncates toward zero, same as C


def exp_phred(x: float) -> float:
    """reference somatic_sniper.h:13: ``exp(-(x)/4.343)``."""
    import math

    return math.exp(-float(x) / PHRED_CONST)
