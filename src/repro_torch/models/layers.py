"""Shared layers: the init half of ``repro/models/layers.py``.

Same tree paths, shapes and dtypes as ``repro``.  The forward functions
(norm, dense with compressed weights, MLP) come with the model forward.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import dense_init, param

__all__ = ["init_rms_norm", "init_dense", "init_embedding", "init_mlp"]


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": param(torch.ones((d,), dtype=torch.float32, device=device), ("embed",))}


def init_dense(generator, d_in: int, d_out: int, axes, dtype, use_bias: bool = False) -> dict:
    p = {"w": dense_init(generator, (d_in, d_out), axes, dtype)}
    if use_bias:
        p["b"] = param(torch.zeros((d_out,), dtype=dtype, device=generator.device), (axes[1],))
    return p


def init_embedding(generator, vocab: int, d: int, dtype) -> dict:
    v = torch.randn((vocab, d), generator=generator, device=generator.device) * d ** -0.5
    return {"table": param(v.to(dtype), ("vocab", "embed"))}


def init_mlp(generator, d: int, d_ff: int, dtype, use_bias: bool = False) -> dict:
    """SwiGLU MLP (gate, up, down)."""
    return {
        "gate": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "up": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "down": init_dense(generator, d_ff, d, ("mlp", "embed"), dtype, use_bias),
    }
