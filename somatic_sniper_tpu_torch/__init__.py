"""somatic_sniper_tpu_torch — the PyTorch/CUDA port of somatic_sniper_tpu.

The fast-precision slab path of the JAX package, run on an NVIDIA GPU:
the host layer (BAM decode, pileup, the native ``paired_plan``, slab
fill, exact scoring and text emission) is imported from
``somatic_sniper_tpu`` unchanged; the device layer is PyTorch plus two
hand-written CUDA kernels (``ops/csrc``).  Nothing in this package
imports JAX.
"""

__version__ = "0.1.0"
