"""Decoders of the port: the dense (llama) and MoE (deepseek-v2-lite)
families, and the LM loss."""
from repro_torch.models.api import Model, get_model, lm_loss

__all__ = ["Model", "get_model", "lm_loss"]
