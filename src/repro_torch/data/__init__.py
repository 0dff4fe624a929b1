"""Request synthesis for the port's serving engine."""

from .requests import make_serving_requests

__all__ = ["make_serving_requests"]
