"""Primitive layers (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the reference's keys;
layer parameters are stacked on a leading ``[n_layers]`` axis.  Each
function reads fp32 parameters and computes in the activation's dtype,
as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

# --------------------------------------------------------------------- #
# init helpers: same shapes and laws as the reference, not the same
# numbers (a torch.Generator is not a jax key)
# --------------------------------------------------------------------- #


def _trunc_normal(shape: Sequence[int], std: float, generator, device):
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, mean=0.0, std=std, a=-3.0 * std,
                                       b=3.0 * std, generator=generator)


def dense_init(generator, shape, in_dim: Optional[int] = None, *,
               lead=(), device="cpu", scale: float = 1.0):
    """Truncated-normal fan-in init (std = scale / sqrt(in_dim)), with
    ``lead`` stacking dims prepended."""
    if in_dim is None:
        in_dim = shape[0]
    std = scale / math.sqrt(max(in_dim, 1))
    return _trunc_normal(tuple(lead) + tuple(shape), std, generator, device)


def embed_init(generator, shape, *, lead=(), device="cpu"):
    return _trunc_normal(tuple(lead) + tuple(shape), 0.02, generator, device)


# --------------------------------------------------------------------- #
# normalization
# --------------------------------------------------------------------- #

def rmsnorm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)  # jnp.var
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def init_norm(d: int, kind: str, *, lead=(), device="cpu"):
    shape = tuple(lead) + (d,)
    if kind == "rmsnorm":
        return {"scale": torch.ones(shape, device=device)}
    return {"scale": torch.ones(shape, device=device),
            "bias": torch.zeros(shape, device=device)}


def apply_norm(x, params, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"], eps)
    return layernorm(x, params["scale"], params["bias"], eps)


# --------------------------------------------------------------------- #
# rotary position embeddings (split-half convention)
# --------------------------------------------------------------------- #

def rope_freqs(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions broadcastable to [..., S].  Rotates
    (x[:D/2], x[D/2:]) pairs, as the reference does."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions.float()[..., None] * freqs          # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------- #

def init_mlp(generator, d: int, d_ff: int, activation: str, *, lead=(),
             device="cpu"):
    kw = dict(lead=lead, device=device)
    if activation == "silu":  # SwiGLU: gate + up + down
        return {
            "w_gate": dense_init(generator, (d, d_ff), d, **kw),
            "w_up": dense_init(generator, (d, d_ff), d, **kw),
            "w_down": dense_init(generator, (d_ff, d), d_ff, **kw),
        }
    return {  # plain GELU MLP (gpt2)
        "w_up": dense_init(generator, (d, d_ff), d, **kw),
        "b_up": torch.zeros(tuple(lead) + (d_ff,), device=device),
        "w_down": dense_init(generator, (d_ff, d), d_ff, **kw),
        "b_down": torch.zeros(tuple(lead) + (d,), device=device),
    }


def apply_mlp(x, params, activation: str):
    dt = x.dtype
    if activation == "silu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
        return h @ params["w_down"].to(dt)
    h = x @ params["w_up"].to(dt) + params["b_up"].to(dt)
    h = F.gelu(h.float(), approximate="tanh").to(dt)
    return h @ params["w_down"].to(dt) + params["b_down"].to(dt)


# --------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------- #

def init_embedding(generator, vocab: int, d: int, *, device="cpu"):
    return {"table": embed_init(generator, (vocab, d), device=device)}


def embed(tokens, params, dtype):
    # gather, then cast: the same values as the reference's cast-then-
    # gather without converting the whole table every step.  F.embedding's
    # backward sums repeated tokens in a fixed order on the card (indexing
    # would scatter-add with atomics), so a rerun repeats its gradients.
    return F.embedding(tokens, params["table"]).to(dtype)


def unembed(x, params, dtype):
    """Project back to vocabulary in the compute dtype, then cast the
    logits to fp32 (greedy-token parity depends on this order)."""
    table = params["table"].to(dtype)
    return (x @ table.t()).float()


def init_learned_positions(generator, max_seq: int, d: int, *,
                           device="cpu"):
    return {"table": embed_init(generator, (max_seq, d), device=device)}
