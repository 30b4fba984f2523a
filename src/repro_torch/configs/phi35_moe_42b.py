"""Phi-3.5-MoE — 42B total / 6.6B active, 16 experts top-2 (a copy of
the reference's ``repro/configs/phi35_moe_42b.py``).

[hf:microsoft/Phi-3.5-MoE-instruct] 32L d_model=4096 32H (GQA kv=8)
expert d_ff=6400 vocab=32064, MoE 16 experts top-2 (no shared experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    rope_theta=10000.0,
    sliding_window=8192,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0,
                  expert_d_ff=6400),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
