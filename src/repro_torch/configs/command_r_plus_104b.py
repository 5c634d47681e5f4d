"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792, vocab 256000; parallel attn+FFN block, no biases.
[hf:CohereForAI/c4ai-command-r-plus]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab_size=256000,
    parallel_block=True,
    use_bias=False,
    rope_theta=75e6,
    tie_embeddings=True,
)
