"""Falcon-Mamba-7B — pure Mamba1 (attention-free SSM).

[arXiv:2410.05355] 64L d_model=4096, d_ff=0 (no MLP; Mamba block is the whole
layer), vocab=65024, ssm_state=16, expand=2 (d_inner=8192), conv kernel 4.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, version=1),
    source="arXiv:2410.05355",
)
