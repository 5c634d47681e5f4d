"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d_model=2048, ssm_state=64) with
a SHARED full-attention transformer block (32H, kv=32, d_ff=8192) invoked
every 6th layer — the block's parameters are reused at every invocation.
At long_500k the shared block uses a 4096-token sliding window so the
hybrid stays sub-quadratic.  [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "ssm_attn"),
    shared_attn=True,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    sliding_window=4096,
    tie_embeddings=True,
    rope_theta=1e4,
)
