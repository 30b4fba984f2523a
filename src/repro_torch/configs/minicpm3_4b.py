"""MiniCPM3-4B — dense decoder with Multi-head Latent Attention (a copy
of the reference's ``repro/configs/minicpm3_4b.py``).

[hf:openbmb/MiniCPM3-4B] 62L d_model=2560 40H (kv=40) d_ff=6400 vocab=73448.
MiniCPM3 uses MLA (DeepSeek-V2 style) with q_lora_rank=768, kv_lora_rank=256.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    head_dim=64,
    rope_theta=10000.0,
    sliding_window=8192,   # long_500k decode variant (see DESIGN.md)
    mla=MLAConfig(kv_lora_rank=256, q_lora_rank=768,
                  rope_head_dim=32, nope_head_dim=64, v_head_dim=64),
    source="hf:openbmb/MiniCPM3-4B",
)
