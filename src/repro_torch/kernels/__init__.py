"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

  * ``rmsnorm``          -- replaces ``repro/kernels/rmsnorm``
  * ``decode_attention`` -- replaces ``repro/kernels/decode_attention``
  * ``flash_attention``  -- replaces ``repro/kernels/flash_attention``
  * ``ssd_scan``         -- replaces ``repro/kernels/ssd_scan``

``build`` compiles ``csrc/*.cu`` with nvcc into one shared library at
first launch on a CUDA tensor.
"""
