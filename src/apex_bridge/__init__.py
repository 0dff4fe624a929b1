"""The only place where the APEX simulator and the PyTorch/CUDA port meet.

``repro.core`` (the simulator: plain Python, no JAX) predicts how a
serving deployment performs from tables of op times; ``repro_torch`` (the
port) runs the real engine and the ops on one NVIDIA card.  Neither
imports the other.  This package joins them to close the paper's loop on
the hardware APEX plans for:

  * ``profiles`` -- ``TorchMeasuredBackend``, a ``ProfileBackend`` whose
    tables the port's profiler measures on the card (wall or device clock);
  * ``ir``       -- ``model_ir``, the Transformer IR of a port config;
  * ``fig6``     -- the H100 twin of ``benchmarks/fig6_fidelity.py``:
    predicted against actual serving time over batch-size caps, for the
    arch named by ``arch`` / ``--arch`` (any arch the engine serves; the
    stub-frontend archs qwen2-vl-7b and seamless-m4t-large-v2 raise, as
    the engine serves token prompts only), cut to ``depth`` blocks, with
    the simulator's pricing departures and one decode step broken down;
  * ``serve``    -- APEX plan search, then the port's engine on one card.

It imports ``repro.core``, ``repro_torch``, torch and the standard
library, and nothing else of ``repro``: ``repro.models`` and
``repro.configs`` load JAX, which the card's machine does not have.

    PYTHONPATH=src python -m apex_bridge.fig6 --arch mixtral-8x7b --size full
    PYTHONPATH=src python -m apex_bridge.serve --arch qwen2-0.5b

Both run on the card unless ``--device cpu`` is passed.
"""
