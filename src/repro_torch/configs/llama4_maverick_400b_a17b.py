"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8),
MoE 128 experts top-1 on alternating layers with a shared expert
(d_ff=8192 per expert; dense layers d_ff=16384), vocab 202048.
[hf:meta-llama/Llama-4-Maverick family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    d_ff_dense=16384,
    vocab_size=202048,
    block_pattern=("attn", "attn_moe"),
    num_experts=128,
    experts_per_token=1,
    moe_shared_expert=True,
    qk_norm=True,
    rope_theta=5e5,
)
