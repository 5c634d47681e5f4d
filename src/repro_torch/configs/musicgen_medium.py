"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144,
decoder-only over EnCodec tokens (4 codebooks, vocab 2048/book).
The EnCodec frontend is a STUB per the task spec: input_specs() provides
precomputed frame embeddings.  [arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    frontend="audio_stub",
    num_codebooks=4,
    use_bias=True,
    rope_theta=1e4,
)
