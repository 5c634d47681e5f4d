"""Model parameter trees (counterpart of ``repro.models``; init only)."""

from repro_torch.models.transformer import init_model, model_dtype

__all__ = ["init_model", "model_dtype"]
