"""Llama-3 405B — the memory giant of the assignment (a copy of the
reference's ``repro/configs/llama3_405b.py``).

[arXiv:2407.21783] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256, rope theta 500000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    rope_theta=500000.0,
    sliding_window=8192,   # long_500k decode variant only
    source="arXiv:2407.21783",
)
