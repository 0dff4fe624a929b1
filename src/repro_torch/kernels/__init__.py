"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

  * ``rmsnorm``          -- replaces ``repro/kernels/rmsnorm``
  * ``decode_attention`` -- replaces ``repro/kernels/decode_attention``
  * ``flash_attention``  -- replaces ``repro/kernels/flash_attention``

``build`` compiles ``csrc/*.cu`` with nvcc into one shared library at
first launch on a CUDA tensor.  The SSD-scan kernel of the JAX package
is not ported yet.
"""
