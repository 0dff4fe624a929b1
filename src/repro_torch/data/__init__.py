"""Data of the port: request synthesis for the serving engine and the
synthetic-token pipeline for the trainer."""

from .pipeline import TokenPipeline
from .requests import make_serving_requests

__all__ = ["TokenPipeline", "make_serving_requests"]
