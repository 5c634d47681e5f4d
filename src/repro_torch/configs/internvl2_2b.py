"""internvl2-2b [vlm]: InternLM2-1.8b language backbone — 24L d_model=2048
16H (GQA kv=8) d_ff=8192, vocab 92553.  The InternViT vision frontend is a
STUB per the task spec: input_specs() provides precomputed patch embeddings.
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_stub",
    rope_theta=1e6,
)
