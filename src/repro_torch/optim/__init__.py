"""Optimisers and schedules (counterpart of ``repro.optim``)."""

from repro_torch.optim.adamw import Optimizer, adafactor, adamw, clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant, warmup_cosine

__all__ = [
    "Optimizer",
    "adamw",
    "adafactor",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
    "constant",
]
