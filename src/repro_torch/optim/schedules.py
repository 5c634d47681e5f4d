"""Learning-rate schedules: counterpart of ``repro/optim/schedules.py``.

Each schedule maps a step (a Python int or a 0-d integer tensor) to the
learning rate as a 0-d float32 tensor on the step's device, with the
reference's arithmetic in float32.
"""

from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def _step_f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def lr(step):
        s = _step_f32(step)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        frac = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(s < warmup, warm, cos)

    return lr


def constant(peak_lr: float):
    def lr(step):
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), peak_lr, dtype=torch.float32, device=dev)

    return lr
