"""GPT-2 medium / large — the paper's own models (Section III-B).

gpt2m: n_ctx=1024 n_embd=1024 n_head=16 n_layer=24.
gpt2L: n_ctx=1024 n_embd=1280 n_head=20 n_layer=30.
gpt2l: the paper's reduced-memory variant of gpt2L with n_layer=26.
Learned positions, LayerNorm, tanh-GELU MLP, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

_COMMON = dict(
    family="dense",
    vocab_size=50257,
    norm="layernorm",
    activation="gelu",
    rope_theta=0.0,        # learned positions, GPT-2 style
    max_seq_len=1024,
    tie_embeddings=True,
)

GPT2_MEDIUM = ModelConfig(
    name="gpt2m", n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, source="paper §III-B (GPT-2 medium)", **_COMMON)

GPT2_LARGE = ModelConfig(
    name="gpt2L", n_layers=30, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, source="paper §III-B (GPT-2 large)", **_COMMON)

GPT2_LARGE_REDUCED = ModelConfig(
    name="gpt2l", n_layers=26, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, source="paper §III-B (gpt2l, n_layer=26)", **_COMMON)
