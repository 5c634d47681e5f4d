"""Architecture registry: ``--arch <id>`` resolution for every assigned
architecture plus the paper's own experiment config."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    CompressionConfig,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    reduced_for_smoke,
)

# arch id -> module name
ARCHITECTURES = {
    "mamba2-130m": "mamba2_130m",
    "qwen3-32b": "qwen3_32b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "command-r-plus-104b": "command_r_plus_104b",
    "llama3-405b": "llama3_405b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "musicgen-medium": "musicgen_medium",
    "internvl2-2b": "internvl2_2b",
    "zamba2-1.2b": "zamba2_1_2b",
}

# archs able to run the long_500k cell (sub-quadratic sequence mixing);
# pure full-attention archs skip it (DESIGN.md §7).
LONG_CONTEXT_ARCHS = ("mamba2-130m", "zamba2-1.2b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHITECTURES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHITECTURES[arch]}")
    return mod.CONFIG


def shape_cells(arch: str) -> list[str]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


__all__ = [
    "ARCHITECTURES",
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "CompressionConfig",
    "ModelConfig",
    "ParallelConfig",
    "ShapeConfig",
    "get_config",
    "shape_cells",
    "reduced_for_smoke",
]
