"""Primitive layers (port of ``repro/models/layers.py``).

Parameters are plain nested dicts of tensors with the reference's keys;
layer parameters are stacked on a leading ``[n_layers]`` axis.  Each
function reads fp32 parameters and computes in the activation's dtype,
as the reference does.

Under a plan that shards weights, ``apply_mlp``, ``embed`` and
``unembed`` take the ``model`` axis (``core.sharding.ModelAxis``) and
this rank's blocks of the leaves it cuts: Megatron's f before a product
whose output dim is cut, g after one whose contraction dim is.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.sharding import (
    ModelAxis, copy_to_model, reduce_from_model,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.rmsnorm import rmsnorm_plain

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

# fp32 mean of squares, rsqrt, times the weight: kernel 6's plain twin
rmsnorm = rmsnorm_plain


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


def apply_norm(x, params, kind: str, eps: float, *,
               use_kernels: bool = False):
    """``use_kernels`` sends RMSNorm through ``ops.rmsnorm``: kernel 6 on
    a CUDA tensor, the plain ``rmsnorm`` on a CPU one.  LayerNorm has no
    kernel."""
    if kind == "rmsnorm":
        if use_kernels:
            return kernel_ops.rmsnorm(x, params["scale"], eps=eps)
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


def apply_mlp(x, params, activation: str,
              model_axis: Optional[ModelAxis] = None):
    """``model_axis``: the hidden dim is cut over it (the dense blocks
    under a weight-sharding plan; never the MoE experts), so the input
    enters through f and the down projection's partial sums are added
    over the axis before ``b_down``."""
    dt = x.dtype
    if model_axis is not None:
        x = copy_to_model(x, model_axis)
    if activation == "silu":
        g = x @ params["w_gate"].to(dt)
        u = x @ params["w_up"].to(dt)
        h = F.silu(g.float()).to(dt) * u
        y = h @ params["w_down"].to(dt)
    else:
        h = x @ params["w_up"].to(dt) + params["b_up"].to(dt)
        h = F.gelu(h.float(), approximate="tanh").to(dt)
        y = h @ params["w_down"].to(dt)
    if model_axis is not None:
        y = reduce_from_model(y, model_axis)
    if "b_down" in params:
        y = y + params["b_down"].to(dt)
    return y


# --------------------------------------------------------------------- #
# embeddings
# --------------------------------------------------------------------- #

def init_embedding(generator, vocab: int, d: int, *, device="cpu"):
    return {"table": embed_init(generator, (vocab, d), device=device)}


def lookup_rows(ids, table, axis: ModelAxis):
    """``table[ids]`` of a table cut on its rows over the ``model`` axis,
    this rank holding rows ``[rank * R, (rank + 1) * R)``: each rank looks
    up the ids it holds, zeros elsewhere, and the ranks' rows are added
    over the axis (exact: one of them is non-zero)."""
    local = ids - axis.rank * table.shape[0]
    held = (local >= 0) & (local < table.shape[0])
    rows = F.embedding(torch.where(held, local, 0), table)
    return reduce_from_model(rows.masked_fill(~held[..., None], 0.0), axis)


def embed(tokens, params, dtype, model_axis: Optional[ModelAxis] = None):
    """``model_axis`` with ``vocab``: this rank holds its block of the
    table's rows (``lookup_rows``)."""
    # gather, then cast: the same values as the reference's cast-then-
    # gather without converting the whole table every step.  F.embedding's
    # backward sums repeated tokens in a fixed order on the card (indexing
    # would scatter-add with atomics), so a rerun repeats its gradients.
    if model_axis is not None and model_axis.vocab:
        return lookup_rows(tokens, params["table"], model_axis).to(dtype)
    return F.embedding(tokens, params["table"]).to(dtype)


def unembed(x, params, dtype, model_axis: Optional[ModelAxis] = None):
    """Project back to vocabulary in the compute dtype, then cast the
    logits to fp32 (greedy-token parity depends on this order).  With
    ``model_axis.vocab`` the logits stay cut over the axis: this rank's
    ``V_l`` columns."""
    table = params["table"].to(dtype)
    if model_axis is not None and model_axis.vocab:
        x = copy_to_model(x, model_axis)
    return (x @ table.t()).float()


def init_learned_positions(generator, max_seq: int, d: int, *,
                           device="cpu"):
    return {"table": embed_init(generator, (max_seq, d), device=device)}
