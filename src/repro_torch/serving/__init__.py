"""Continuous-batching serving engine of the port, and the multi-replica
routers (``router``, the port's copy of ``repro/serving/router.py``).

``ServingEngine``, ``EngineReport`` and ``RequestResult`` are imported
lazily (PEP 562), as the reference does: the router and the disaggregated
simulator only need the torch-free dispatch logic, so importing this
package must not load the engine, the models or the kernel wrappers.
"""

from .router import BacklogBalancer, PoolRouter, ReplicaRouter

__all__ = ["BacklogBalancer", "EngineReport", "PoolRouter", "ReplicaRouter",
           "RequestResult", "ServingEngine"]


def __getattr__(name):
    if name in ("EngineReport", "RequestResult", "ServingEngine"):
        from . import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
