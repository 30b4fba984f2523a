"""Phi-3-Vision-4.2B — phi3-mini LM backbone + CLIP vision frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064.  A copy of the reference's config.  The ViT/CLIP
image encoder is a stub: a batch carries precomputed patch embeddings,
``patch_embeds`` [B, 576, 1024] (CLIP ViT-L/14 gives 1024-dim patch
features); the model is the projector and the LM decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    sliding_window=8192,
    vision_dim=1024,       # CLIP ViT-L/14 patch feature dim
    n_patches=576,         # 24x24 patches per image tile
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)
