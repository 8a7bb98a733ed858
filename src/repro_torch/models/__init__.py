"""Decoders of the port: the dense (llama) and MoE (deepseek-v2-lite) families."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
