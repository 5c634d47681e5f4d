"""GQA attention: the init half of ``repro/models/attention.py``.

The attention forward, KV cache and the flash-attention kernel (K5) come
with the model forward (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.params import param

__all__ = ["init_attention"]


def init_attention(generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": layers.init_dense(generator, d, H * hd, ("embed", "heads"), dtype, cfg.use_bias),
        "wk": layers.init_dense(generator, d, KV * hd, ("embed", "kv"), dtype, cfg.use_bias),
        "wv": layers.init_dense(generator, d, KV * hd, ("embed", "kv"), dtype, cfg.use_bias),
        "wo": layers.init_dense(generator, H * hd, d, ("heads", "embed"), dtype, cfg.use_bias),
    }
    if cfg.qk_norm:
        ones = lambda: torch.ones((hd,), dtype=torch.float32, device=generator.device)  # noqa: E731
        p["q_norm"] = {"scale": param(ones(), (None,))}
        p["k_norm"] = {"scale": param(ones(), (None,))}
    return p
