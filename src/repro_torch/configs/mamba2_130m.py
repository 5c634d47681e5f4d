"""mamba2-130m [ssm]: 24L d_model=768, attention-free SSD (state-space
duality), ssm_state=128, vocab 50280.  [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,          # unused (attention-free); kept for interface
    num_kv_heads=12,
    d_ff=0,                # attention-free, no MLP: SSD blocks only
    vocab_size=50280,
    block_pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)
