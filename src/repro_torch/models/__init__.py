"""Model parameter trees and the forward pass (counterpart of ``repro.models``)."""

from repro_torch.models.transformer import (
    forward,
    init_cache,
    init_model,
    model_dtype,
    train_loss,
)

__all__ = ["init_model", "forward", "train_loss", "init_cache", "model_dtype"]
