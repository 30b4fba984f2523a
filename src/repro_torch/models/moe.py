"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): a top-k
router and sort-based capacity dispatch.

Tokens are sorted by their assigned expert (stable), packed into a
fixed-capacity ``[E, C, d]`` buffer, run through every expert's SwiGLU
as batched products and scattered back weighted by the router.  The
products are plain matrix products, which the reference leaves to XLA
outside Pallas; here they are batched ``matmul``s (cuBLAS on the
card).  The reference's ``moe_dispatch_axes`` and ``moe_expert_axis``
paths belong to plans across devices (ROADMAP queue 1, item 7); on one
device ``moe_forward`` is ``_moe_forward_impl``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp, dense_init


def init_moe(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    m, d = cfg.moe, cfg.d_model
    eff = m.expert_d_ff or cfg.d_ff
    E = m.n_experts
    kw = dict(lead=lead, device=device)
    p = {
        "router": dense_init(generator, (d, E), d, **kw),
        "w_gate": dense_init(generator, (E, d, eff), d, **kw),
        "w_up": dense_init(generator, (E, d, eff), d, **kw),
        "w_down": dense_init(generator, (E, eff, d), eff, **kw),
    }
    if m.n_shared_experts:
        ns = m.n_shared_experts
        p["shared_gate"] = dense_init(generator, (d, ns * eff), d, **kw)
        p["shared_up"] = dense_init(generator, (d, ns * eff), d, **kw)
        p["shared_down"] = dense_init(generator, (ns * eff, d), ns * eff,
                                      **kw)
    return p


def _expert_ffn(buf, params):
    """buf: [E, C, d] -> [E, C, d] through each expert's SwiGLU (the
    dense MLP's, batched over the leading expert axis of the weights)."""
    return apply_mlp(buf, params, "silu")


def route(xf, params, cfg: ModelConfig):
    """Router of tokens xf [T, d]: (probs [T, E] fp32, gate values [T, k]
    renormalised over the top k, choices [T, k]).  The product runs in
    the model dtype, only the softmax in fp32."""
    logits = xf @ params["router"].to(xf.dtype)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, choices = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, choices


def moe_forward(x, params, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss).  One device: the
    reference's global routing, ``_moe_forward_impl``."""
    return _moe_forward_impl(x, params, cfg)


def _moe_forward_impl(x, params, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d].  Returns (out, aux_loss).

    aux_loss is the load-balance loss ``E * sum_e f_e * p_e *
    router_aux_coef``, with f_e the fraction of routing choices that go
    to expert e and p_e its mean router probability."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    dt, dev = x.dtype, x.device
    xf = x.reshape(T, d)
    probs, gate_vals, choices = route(xf, params, cfg)

    # ---- load-balance auxiliary ------------------------------------- #
    f_e = F.one_hot(choices, E).float().sum(dim=1).mean(dim=0)  # [E]
    p_e = probs.mean(dim=0)
    aux = E * (f_e * p_e).sum() * m.router_aux_coef

    # ---- sort-based dispatch ---------------------------------------- #
    # the capacity floor keeps tiny decode batches drop-free
    cap = min(max(int(m.capacity_factor * T * k / E) + 1, min(T, 16)), T)
    flat_expert = choices.reshape(-1)                            # [T*k]
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    # rank within expert = running index - offset of the expert's first
    counts = torch.bincount(sorted_expert, minlength=E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - offsets[sorted_expert]
    keep = rank < cap
    slot = sorted_expert * cap + torch.where(keep, rank, 0)     # [T*k]

    # every kept choice has a slot of its own; a dropped one adds zeros to
    # its expert's slot 0, so each slot sums one value and zeros, the
    # same bits in any order of the adds (the card's index_add_ order is
    # not fixed)
    gathered = torch.where(keep[:, None], xf[sorted_token],
                           torch.zeros((), dtype=dt, device=dev))
    buf = torch.zeros((E * cap, d), dtype=dt, device=dev).index_add(
        0, slot, gathered)
    out_buf = _expert_ffn(buf.reshape(E, cap, d), params).reshape(E * cap, d)

    contrib = out_buf[slot] * (sorted_gate * keep)[:, None].to(dt)
    # the combine: each token receives its top_k contributions into a
    # zero row.  With top_k = 2 (phi3.5-MoE, every reduced config) that is
    # 0 + a + b, which rounds once whichever lands first, so the card's
    # unordered index_add_ gives the bits of the reference's ordered
    # scatter; for top_k > 2 the order would matter
    out = torch.zeros((T, d), dtype=dt, device=dev).index_add(
        0, sorted_token, contrib)

    # ---- shared (always-on) experts ---------------------------------- #
    if m.n_shared_experts:
        out = out + apply_mlp(xf, {"w_gate": params["shared_gate"],
                                   "w_up": params["shared_up"],
                                   "w_down": params["shared_down"]}, "silu")
    return out.reshape(B, S, d), aux
