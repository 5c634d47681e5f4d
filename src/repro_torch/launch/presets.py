"""Per-(arch x shape) parallelism presets for the production mesh: a copy of
``repro/launch/presets.py`` (no JAX in it).

Chosen from the memory budget of a TPU v5e chip (16 GB HBM; DESIGN.md §5):

  * >= 200B params  -> adafactor + bf16 grad accumulation (fp32 accum alone
                       would be 6.3 GB/chip for llama3-405b)
  * >= 50B          -> adafactor, fp32 accum
  * otherwise       -> adamw, fp32 accum
  * train microbatches scale with size so one microbatch's remat stash plus
    logits stay ~1-2 GB/chip.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig

__all__ = ["parallel_preset"]


def parallel_preset(
    cfg: ModelConfig, shape: ShapeConfig, *, multi_pod: bool = False
) -> ParallelConfig:
    mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = cfg.param_count()

    # Small models (<3B) don't benefit from 16-way TP on a 256-chip mesh —
    # indivisible inner dims cause resharding blowups; the whole mesh acts
    # as DP instead (params replicated across `model`, FSDP over `data`).
    # Requires the global batch to tile the full mesh.
    dm = 1
    for ax, dim in zip(mesh_axes, mesh_shape):
        if ax in ("data", "model"):
            dm *= dim
    dp_small = (
        n < 3e9
        and shape.kind == "train"
        and shape.global_batch % dm == 0  # suffix fallback handles the pod axis
    )

    if n >= 2e11:
        optimizer, accum, micro = "adafactor", "bfloat16", 16
    elif n >= 5e10:
        optimizer, accum, micro = "adafactor", "float32", 8
    elif n >= 5e9:
        optimizer, accum, micro = "adamw", "float32", 4
    else:
        optimizer, accum, micro = "adamw", "float32", 1

    if shape.kind != "train":
        micro = 1

    # each microbatch's global batch must still tile the dp axes: with
    # GB=256 and 32 dp shards (multi-pod), 16 microbatches would leave a
    # 16-row microbatch on 32 shards -> GSPMD replicates (measured +70
    # GiB/device on llama3-405b; EXPERIMENTS.md §Perf).
    dp_axes = ("pod", "data", "model") if dp_small else ("pod", "data")
    dp_size = 1
    for ax, dim in zip(mesh_axes, mesh_shape):
        if ax in dp_axes:
            dp_size *= dim
    micro = max(min(micro, shape.global_batch // dp_size), 1)
    while shape.global_batch % micro != 0 or (shape.global_batch // micro) % dp_size != 0:
        micro -= 1
        if micro <= 1:
            micro = 1
            break

    return ParallelConfig(
        mesh_shape=mesh_shape,
        mesh_axes=mesh_axes,
        microbatches=max(micro, 1),
        seq_shard_activations=shape.kind == "train",
        fsdp=True,
        remat=True,
        optimizer=optimizer,
        accum_dtype=accum,
        dp_includes_model=dp_small,
    )
