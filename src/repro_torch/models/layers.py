"""Shared layers: counterpart of ``repro/models/layers.py``.

Same tree paths, shapes and dtypes as ``repro``.  ``apply_dense`` takes a
dense weight or a compressed ``{m_packed, C}`` one (through
``quantized.apply_compressed``, hence kernel K3 when the hook is set).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quantized
from repro_torch.models.params import Param, dense_init, param

__all__ = [
    "rms_norm",
    "init_rms_norm",
    "apply_dense",
    "init_dense",
    "init_embedding",
    "embed_lookup",
    "init_mlp",
    "mlp",
]


def _value(p):
    return p.value if isinstance(p, Param) else p


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": param(torch.ones((d,), dtype=torch.float32, device=device), ("embed",))}


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 (scale f32), cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * _value(p["scale"])).to(x.dtype)


def init_dense(generator, d_in: int, d_out: int, axes, dtype, use_bias: bool = False) -> dict:
    p = {"w": dense_init(generator, (d_in, d_out), axes, dtype)}
    if use_bias:
        p["b"] = param(torch.zeros((d_out,), dtype=dtype, device=generator.device), (axes[1],))
    return p


def apply_dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w (+ b) for a dense, a compressed ``{m_packed, C}`` or an int8
    ``{q, scale}`` weight."""
    w = _value(p["w"])
    if quantized.is_compressed(w):
        y = quantized.apply_compressed(x, w)
    elif quantized.is_intquant(w):
        y = quantized.apply_intquant(x, w)
    else:
        y = x @ w
    if "b" in p:
        y = y + _value(p["b"])
    return y


def init_embedding(generator, vocab: int, d: int, dtype) -> dict:
    v = torch.randn((vocab, d), generator=generator, device=generator.device) * d ** -0.5
    return {"table": param(v.to(dtype), ("vocab", "embed"))}


def embed_lookup(tokens: torch.Tensor, p: dict) -> torch.Tensor:
    return _value(p["table"])[tokens]


def init_mlp(generator, d: int, d_ff: int, dtype, use_bias: bool = False) -> dict:
    """SwiGLU MLP (gate, up, down)."""
    return {
        "gate": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "up": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "down": init_dense(generator, d_ff, d, ("mlp", "embed"), dtype, use_bias),
    }


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    g = apply_dense(x, p["gate"])
    u = apply_dense(x, p["up"])
    return apply_dense(F.silu(g) * u, p["down"])
