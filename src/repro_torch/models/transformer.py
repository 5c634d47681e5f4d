"""Decoder backbone: the init half of ``repro/models/transformer.py``.

``init_model`` builds the same parameter tree as ``repro``'s (group
parameters stacked along a leading ``num_groups`` axis, e.g.
``groups/0/attn/wk/w`` of shape (num_groups, d_model, kv_heads*head_dim)),
with weights drawn from a ``torch.Generator``.  Dense attention blocks are
ported; MoE and SSM blocks, the shared attention block and the forward
pass come with the next slices (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers
from repro_torch.models.params import Param

__all__ = ["init_model", "model_dtype"]


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _init_block(generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    if kind != "attn":
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (attn only; ROADMAP.md)"
        )
    d, dev = cfg.d_model, generator.device
    return {
        "norm1": layers.init_rms_norm(d, dtype, dev),
        "attn": attn_lib.init_attention(generator, cfg, dtype),
        "norm2": layers.init_rms_norm(d, dtype, dev),
        "mlp": layers.init_mlp(generator, d, cfg.d_ff_dense or cfg.d_ff, dtype, cfg.use_bias),
    }


def _stack(trees):
    """Stack identically-structured Param trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, Param):
        return Param(torch.stack([t.value for t in trees]), (None,) + first.axes)
    return {k: _stack([t[k] for t in trees]) for k in first}


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None):
    """A Param tree (values + logical axes; use ``params.split``) on
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    if cfg.shared_attn:
        raise NotImplementedError("shared attention blocks are not ported yet")
    dtype = model_dtype(cfg)
    g = make_generator(device, seed)
    groups = _stack([
        {f"{i}": _init_block(g, kind, cfg, dtype) for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.num_groups)
    ])
    p = {
        "embed": layers.init_embedding(g, cfg.vocab_size, cfg.d_model, dtype),
        "groups": groups,
        "final_norm": layers.init_rms_norm(cfg.d_model, dtype, device),
    }
    if cfg.remainder_pattern:
        p["rem"] = {
            f"{i}": _init_block(g, kind, cfg, dtype)
            for i, kind in enumerate(cfg.remainder_pattern)
        }
    if not cfg.tie_embeddings:
        p["head"] = layers.init_dense(g, cfg.d_model, cfg.vocab_size, ("embed", "vocab"), dtype)
    return p
