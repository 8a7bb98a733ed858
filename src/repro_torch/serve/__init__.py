"""Serving engine of the port."""
from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

__all__ = ["Request", "ServeConfig", "ServeEngine"]
