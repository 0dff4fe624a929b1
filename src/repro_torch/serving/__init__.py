"""Continuous-batching serving engine of the port, and the multi-replica
routers (``router``, the port's copy of ``repro/serving/router.py``)."""

from .engine import EngineReport, RequestResult, ServingEngine
from .router import BacklogBalancer, PoolRouter, ReplicaRouter

__all__ = ["BacklogBalancer", "EngineReport", "PoolRouter", "ReplicaRouter",
           "RequestResult", "ServingEngine"]
