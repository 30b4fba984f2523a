"""Whisper-small — encoder-decoder with conv/mel frontend (stub).

[arXiv:2212.04356] 12L (both encoder and decoder) d_model=768 12H (kv=12)
d_ff=3072 vocab=51865.  A copy of the reference's config.  The
mel-spectrogram + conv feature extractor is a stub: a batch carries
precomputed frame embeddings, ``frames`` [B, 1500, d_model] (1500 frames
= 30 s of audio after the conv stride-2).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,            # decoder layers
    n_enc_layers=12,
    enc_seq_len=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    norm="layernorm",
    activation="gelu",
    rope_theta=0.0,         # whisper uses learned/sinusoidal positions
    max_seq_len=448 * 128,  # structurally allow long decode shapes
    source="arXiv:2212.04356",
)
