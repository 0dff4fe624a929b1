"""PyTorch/CUDA port of the real-execution half of the APEX reproduction.

The layout mirrors ``repro/`` (the JAX reference) so each module has an
obvious counterpart: ``layers/``, ``models/``, ``kernels/``,
``serving/engine.py``, ``launch/serve.py``.  This package imports only
``torch``, ``numpy`` and the standard library; it keeps its own copies of
the configuration schema and trace synthesis.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  On a
CUDA tensor every ported kernel launches its hand-written CUDA C++ kernel
(built from ``kernels/csrc`` at first use); on a CPU tensor it runs the
plain PyTorch version kept beside it.
"""

from .device import DTYPES, resolve_device, torch_dtype

__all__ = ["DTYPES", "resolve_device", "torch_dtype"]
