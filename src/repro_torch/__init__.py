"""PyTorch/CUDA port of the APEX reproduction.

The layout mirrors ``repro/`` (the JAX reference) so each module has an
obvious counterpart: ``layers/``, ``models/``, ``kernels/``,
``serving/engine.py``, ``launch/serve.py``, and APEX's planner and
simulator in ``core/`` and ``serving/router.py``.  This package imports
only ``torch``, ``numpy`` and the standard library; it keeps its own
copies of the configuration schema, trace synthesis and the simulator.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  On a
CUDA tensor every ported kernel launches its hand-written CUDA C++ kernel
(built from ``kernels/csrc`` at first use); on a CPU tensor it runs the
plain PyTorch version kept beside it.
"""

from .device import DTYPES, resolve_device, torch_dtype

__all__ = ["DTYPES", "resolve_device", "torch_dtype"]
