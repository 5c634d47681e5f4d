"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8),
MoE 32 experts top-8, d_ff=512/expert, vocab 49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("attn_moe",),
    num_experts=32,
    experts_per_token=8,
    tie_embeddings=True,
    rope_theta=1e4,
)
