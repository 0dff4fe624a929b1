"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.

  * ``rmsnorm``          -- replaces ``repro/kernels/rmsnorm``
  * ``decode_attention`` -- replaces ``repro/kernels/decode_attention``
  * ``flash_attention``  -- replaces ``repro/kernels/flash_attention``
  * ``ssd_scan``         -- replaces ``repro/kernels/ssd_scan``

A wrapper launches its kernel on CUDA tensors and runs the plain
version on CPU tensors and on meta tensors (``build.PLAIN_DEVICES``),
which have no data for a kernel to read.

``build`` compiles ``csrc/*.cu`` with nvcc into one shared library at
first launch on a CUDA tensor.
"""
