"""Zamba2-2.7B — Mamba2 backbone + shared attention block (hybrid).

[arXiv:2411.15242] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64 (Mamba2/SSD).  Zamba2 interleaves a *shared* full-attention
block (one set of weights, re-applied) every 6 Mamba2 layers; this is
modelled with ``hybrid_attn_every=6`` and a single shared attention+MLP
param group.  Attention head_dim is 2560 / 32 = 80.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10000.0,
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, version=2, head_dim=64,
                  chunk=64),
    source="arXiv:2411.15242",
)
