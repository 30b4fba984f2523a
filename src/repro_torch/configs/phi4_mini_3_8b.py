"""Phi-4-mini 3.8B — RoPE + SwiGLU + GQA dense decoder, 200k vocab (a
copy of the reference's ``repro/configs/phi4_mini_3_8b.py``).

[arXiv:2412.08905] 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
    sliding_window=8192,
    tie_embeddings=True,
    source="arXiv:2412.08905",
)
