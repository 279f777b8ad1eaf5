"""Post-processing filters for the caller's output.

Copies of somatic_sniper_tpu/scripts/*.py: the port keeps its own
and imports nothing of the JAX package.
"""
