"""Llama-3.2 3B — small llama3-family dense decoder (a copy of the
reference's ``repro/configs/llama3_2_3b.py``).

[hf:meta-llama/Llama-3.2-1B family] 28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500000.0,
    sliding_window=8192,
    tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
