"""Dense pre-norm block (port of the dense part of
``repro/models/blocks.py``): init, forward, prefill and decode.

``init_dense_block`` makes every leaf with a leading ``lead`` shape, so
``lead=(n_layers,)`` gives the stacked ``[L, ...]`` layout the reference
builds with ``vmap``; the other functions take one layer's slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp, apply_norm, init_mlp, init_norm,
)


def init_dense_block(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    kw = dict(lead=lead, device=device)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, **kw),
        "norm2": init_norm(cfg.d_model, cfg.norm, **kw),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation,
                        **kw),
        "attn": attn.init_attention(generator, cfg, **kw),
    }


def _mlp_residual(x, p, cfg: ModelConfig):
    h = apply_norm(x, p["norm2"], cfg.norm, cfg.norm_eps)
    return x + apply_mlp(h, p["mlp"], cfg.activation)


def dense_block_forward(x, p, cfg: ModelConfig, *, positions=None,
                        window: int = 0, use_kernels: bool = True):
    h = apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    x = x + attn.attention_forward(h, p["attn"], cfg, positions=positions,
                                   window=window, use_kernels=use_kernels)
    return _mlp_residual(x, p, cfg)


def dense_block_prefill(x, p, cfg: ModelConfig, *, positions=None, cache,
                        window: int = 0, use_kernels: bool = True):
    h = apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    a, cache = attn.attention_prefill(h, p["attn"], cfg, positions=positions,
                                      cache=cache, window=window,
                                      use_kernels=use_kernels)
    return _mlp_residual(x + a, p, cfg), cache


def dense_block_decode(x, p, cfg: ModelConfig, *, cache, window: int = 0,
                       use_kernels: bool = True):
    h = apply_norm(x, p["norm1"], cfg.norm, cfg.norm_eps)
    a, cache = attn.attention_decode(h, p["attn"], cfg, cache=cache,
                                     window=window, use_kernels=use_kernels)
    return _mlp_residual(x + a, p, cfg), cache
