"""Dense decoder of the port (llama family)."""
from repro_torch.models.api import Model, get_model

__all__ = ["Model", "get_model"]
