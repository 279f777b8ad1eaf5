"""somatic_sniper_tpu_torch — the PyTorch/CUDA port of somatic_sniper_tpu.

The fast-precision paths of the JAX package, run on an NVIDIA GPU: the
slab path and the non-plan batch path (u16 and full-u32 column
batches).  The host layer (BAM decode, pileup, the native
``paired_plan``, slab fill, exact scoring and text emission) is the
package's own copy of the JAX package's, module for module under the
same names; the device layer is PyTorch plus four hand-written CUDA
kernels (``ops/csrc``).  Nothing in this package imports JAX or the JAX
package.
"""

__version__ = "0.1.0"
