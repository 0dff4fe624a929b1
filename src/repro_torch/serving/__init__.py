"""Continuous-batching serving engine of the port."""

from .engine import EngineReport, RequestResult, ServingEngine

__all__ = ["EngineReport", "RequestResult", "ServingEngine"]
