"""Modality frontends: stubs, as in ``repro/models/frontends.py``.

``[audio]`` (musicgen) and ``[vlm]`` (internvl2) architectures take
precomputed frame/patch embeddings (B, S, d_model); smoke runs synthesise
them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["stub_embeddings", "needs_embeds"]


def needs_embeds(cfg: ModelConfig) -> bool:
    return cfg.frontend in ("audio_stub", "vision_stub")


def stub_embeddings(generator: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Deterministic stand-in for EnCodec frames / InternViT patches, on the
    generator's device."""
    x = torch.randn((batch, seq, cfg.d_model), generator=generator, device=generator.device)
    return (0.02 * x).to(dtype)
