"""The emitted-site record type shared by all output formatters
(mirrors sniper_output_t / sample_data_t, reference output_format.h:13-36).

Copy of somatic_sniper_tpu/output/records.py: the port keeps its own host layer
and imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

from .dqstats import DqStats


@dataclass(slots=True)
class SampleData:
    genotype: int
    joint_genotype: int
    joint_consensus_quality: int
    consensus_quality: int
    variant_allele_quality: int
    somatic_score: int
    variant_status: int
    dqstats: DqStats


@dataclass(slots=True)
class SniperRecord:
    seq_name: str
    pos: int          # 0-based
    ref_base: int     # raw reference character (ord), case preserved
    ref_base4: int    # 4-bit code
    tumor: SampleData
    normal: SampleData


@dataclass(slots=True)
class HeaderData:
    refseq: str
    normal_sample_id: str = "NORMAL"
    tumor_sample_id: str = "TUMOR"
