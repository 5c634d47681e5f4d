"""Configuration system: model architecture, input shapes, parallelism.

Every assigned architecture gets a ``src/repro_torch/configs/<id>.py`` (a copy of
``repro``'s) exporting
``CONFIG: ModelConfig``; the registry in ``repro_torch.configs`` resolves
``--arch <id>``.  Shapes are the four assigned input-shape cells; parallelism
is a separate config so the same model runs on a laptop mesh or a multi-pod
production mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "ParallelConfig",
    "CompressionConfig",
    "SHAPES",
    "reduced_for_smoke",
]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Integer-decomposition compression of linear weights (the paper's
    technique as a deployable feature).  ``rank_ratio`` sets K = ratio *
    tile_n; matrices smaller than ``min_size`` stay dense."""

    enabled: bool = False
    tile_n: int = 32           # rows per tile (N in the paper)
    tile_d: int = 128          # cols per tile (D in the paper)
    rank_ratio: float = 0.125  # K / tile_n  (memory ~ ratio + 16*K/tile_d)
    min_size: int = 1 << 16    # only compress matrices with >= this many elems
    optimizer: str = "alternating"  # greedy | alternating | bbo (refinement)
    bbo_iters: int = 64        # only for optimizer="bbo"
    solver_backend: str = "auto"    # Ising backend for bbo: auto | cuda | torch

    def to_policy(self):
        """One-rule :class:`repro_torch.compression.CompressionPolicy` adapter:
        every tensor gets this config's single method/tile/rank (the legacy
        ``compress_params`` semantics)."""
        from repro_torch.compression.policy import CompressionPolicy

        return CompressionPolicy.from_config(self)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # block structure: scan runs over groups of len(block_pattern) layers
    block_pattern: Tuple[str, ...] = ("attn",)   # attn | attn_moe | ssm | ssm_attn
    # attention variants
    qk_norm: bool = False
    use_bias: bool = False
    parallel_block: bool = False    # command-r style parallel attn+mlp
    rope_theta: float = 1e6
    sliding_window: int = 0         # 0 = full causal; >0 = sliding window
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    d_ff_dense: int = 0             # d_ff of non-MoE layers (0 -> d_ff)
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    ssm_dconv: int = 4
    # hybrid: zamba2's shared attention block (one param set reused)
    shared_attn: bool = False
    # modality frontend (STUB per task spec: precomputed embeddings)
    frontend: str = "none"          # none | audio_stub | vision_stub
    num_codebooks: int = 0          # musicgen
    # numerics / structure
    dtype: str = "bfloat16"
    remat: bool = True
    logits_softcap: float = 0.0
    z_loss: float = 1e-4
    compression: CompressionConfig = CompressionConfig()

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> Tuple[str, ...]:
        return self.block_pattern[: self.num_layers % len(self.block_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        counts = {"embed": V * d + (0 if self.tie_embeddings else V * d)}
        per = {}
        per["attn"] = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d + 2 * d \
            + (2 * hd if self.qk_norm else 0) \
            + 3 * d * (self.d_ff_dense or ff)
        e = max(self.num_experts, 1)
        per["attn_moe"] = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d + 2 * d + e * 3 * d * ff + d * e \
            + (3 * d * ff if self.moe_shared_expert else 0)
        di, ds, ng, nh = self.d_inner, self.ssm_state, self.ssm_ngroups, self.ssm_nheads
        per["ssm"] = d * (2 * di + 2 * ng * ds + nh) + (di + 2 * ng * ds) * self.ssm_dconv \
            + 3 * nh + di + di * d + d
        per["ssm_attn"] = per["ssm"]  # shared attn params counted once below
        total = counts["embed"] + 2 * d  # final norm (+2d slack)
        for kind in self.block_pattern * self.num_groups + self.remainder_pattern:
            total += per[kind]
        if self.shared_attn:
            total += per["attn"]
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        inactive_per_moe = (self.num_experts - self.experts_per_token) * 3 * d * ff
        n_moe = sum(
            1 for k in self.block_pattern * self.num_groups + self.remainder_pattern
            if k == "attn_moe"
        )
        return self.param_count() - n_moe * inactive_per_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch          # one new token per sequence
        return self.global_batch * self.seq_len


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the mesh (see distributed/sharding.py)."""

    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    microbatches: int = 1            # gradient-accumulation steps
    seq_shard_activations: bool = True   # SP: shard scan carry seq over model
    fsdp: bool = True                # shard params/opt-state over data axis
    dp_includes_model: bool = False  # small models: whole mesh is DP, no TP
    remat: bool = True
    grad_compress: bool = False      # int8 error-feedback DP all-reduce
    optimizer: str = "adamw"         # adamw | adafactor
    accum_dtype: str = "float32"

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))


def reduced_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (task requirement)."""
    n_pat = len(cfg.block_pattern)
    return dataclasses.replace(
        cfg,
        num_layers=max(2 * n_pat, n_pat),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        d_ff_dense=128 if cfg.d_ff_dense else 0,
        vocab_size=257,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.experts_per_token else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16,
        ssm_chunk=16,
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        dtype="float32",
    )
