"""The reference package's jax-free host helpers, for scripts that drive
the port.

The port shares the reference package's host layer (BAM index and
native pileup loading, model tables, run statistics, the fast-precision
contract, the pair simulator); those modules import no JAX.  A script
that drives the port (``chip_smoke.py``) imports them from here, so that
it imports nothing of the reference package itself.
"""

from somatic_sniper_tpu.io import bai, native_api
from somatic_sniper_tpu.models.tables import ModelParams, build_tables
from somatic_sniper_tpu.utils.contract import diff_records, hist
from somatic_sniper_tpu.utils.simulate import SimConfig, simulate_pair_fast
from somatic_sniper_tpu.utils.stats import STATS

__all__ = [
    "STATS",
    "ModelParams",
    "SimConfig",
    "bai",
    "build_tables",
    "diff_records",
    "hist",
    "native_api",
    "simulate_pair_fast",
]
