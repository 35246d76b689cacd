"""LeNet-300-100 and the FL model facade; the LLM families' registry."""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
