"""Mixture-of-Experts layer (port of ``repro/models/moe.py``): a top-k
router and sort-based capacity dispatch.

Tokens are sorted by their assigned expert (stable), packed into a
fixed-capacity ``[E, C, d]`` buffer, run through every expert's SwiGLU
as batched products and combined back weighted by the router, each
token's contributions added in the reference's order for any top_k.  The
products are plain matrix products, which the reference leaves to XLA
outside Pallas; here they are batched ``matmul``s (cuBLAS on the
card).

On one device ``moe_forward`` is the reference's ``_moe_forward_impl``:
every token of the batch routed as one.  Under a plan (``core.steps``)
a ``Dispatch`` says which tokens route together, the reference's
semantics:

  * the flat plans (the reference's ``moe_dispatch_axes``): each batch
    rank routes its own tokens with its own capacity, and adds its aux
    divided by the ranks' count, so that the sum ``PlanStep`` takes over
    the ranks is the mean of their auxes (the reference's ``pmean``);
  * pipeshard: the ranks' tokens route as one global microbatch.  A
    token's rank within its expert is its rank among this rank's tokens
    plus that expert's counts on the lower batch ranks (one all-gather
    of ``E`` integers), the capacity is the whole microbatch's, and
    ``f_e`` and ``p_e`` are sums over the ranks: each rank adds its
    share ``E * sum_e f_e * p_e(mine)``, which add up to the aux.

With ``model_axis.experts`` (the plans that shard weights, ``n_experts``
divisible by the ``model`` axis) each model rank runs its own experts'
slots of the buffer and the combine is summed over the axis; the router
stays whole on every rank, the shared experts take the dense MLP's cut.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import (
    ModelAxis, all_gather, copy_to_model, reduce_from_model,
)
from repro_torch.models.layers import apply_mlp, dense_init


@dataclass(frozen=True)
class Dispatch:
    """Which tokens a plan routes together (see the module docstring):
    the batch ranks' process group, their count and this rank's place;
    ``whole``: their tokens route as one batch (pipeshard), else each
    rank's on their own (the flat plans)."""
    group: Any
    size: int
    rank: int
    whole: bool


def _counts(experts, E: int):
    """How many of ``experts`` (int64 ids in [0, E)) name each expert:
    ``torch.bincount(experts, minlength=E)``'s values, whose length does
    not depend on the ids (an exact integer sum, so a meta tensor, the
    dry run's, has a shape for it too)."""
    return torch.zeros(E, dtype=torch.long, device=experts.device) \
        .index_add_(0, experts, torch.ones_like(experts))


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


def moe_forward(x, params, cfg: ModelConfig, *,
                dispatch: Optional[Dispatch] = None,
                model_axis: Optional[ModelAxis] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] -> (out [B, S, d], aux loss), routed as ``dispatch``
    says, the experts cut over ``model_axis`` when it says so.  Without
    either, the reference's ``_moe_forward_impl``: this batch routed as
    one.

    aux_loss is the load-balance loss ``E * sum_e f_e * p_e *
    router_aux_coef``, with f_e the fraction of routing choices that go
    to expert e and p_e its mean router probability."""
    m = cfg.moe
    B, S, d = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    dt, dev = x.dtype, x.device
    xf = x.reshape(T, d)
    probs, gate_vals, choices = route(xf, params, cfg)
    flat_expert = choices.reshape(-1)                            # [T*k]
    whole = dispatch is not None and dispatch.whole

    # ---- load-balance auxiliary ------------------------------------- #
    if whole:
        # counts of every batch rank's choices [ranks, E]; this rank's
        # share of the aux of their tokens together
        every = all_gather(_counts(flat_expert, E)[None],
                           dispatch.group, 0)
        below = every[:dispatch.rank].sum(0)
        T_all = T * dispatch.size
        f_e = every.sum(0).float() / T_all
        aux = E * (f_e * (probs.sum(dim=0) / T_all)).sum() \
            * m.router_aux_coef
    else:
        f_e = F.one_hot(choices, E).float().sum(dim=1).mean(dim=0)  # [E]
        p_e = probs.mean(dim=0)
        aux = E * (f_e * p_e).sum() * m.router_aux_coef
        if dispatch is not None:
            aux = aux / dispatch.size
        T_all = T

    # ---- sort-based dispatch ---------------------------------------- #
    # the capacity floor keeps tiny decode batches drop-free
    cap = min(max(int(m.capacity_factor * T_all * k / E) + 1,
                  min(T_all, 16)), T_all)
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    sorted_token = flat_token[order]
    sorted_gate = flat_gate[order]
    # rank within expert = running index - offset of the expert's first
    counts = _counts(sorted_expert, E)
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=dev) - offsets[sorted_expert]
    # a token's place in its expert's queue over the whole batch: after
    # the lower batch ranks' tokens (their slots are theirs to fill, so
    # this rank's buffer slot is its rank among its own tokens)
    keep = (rank + below[sorted_expert] if whole else rank) < cap
    # this rank's experts: all of them, or its block over the model axis
    cut = model_axis is not None and model_axis.experts
    E_l = E // model_axis.size if cut else E
    local = sorted_expert - (model_axis.rank * E_l if cut else 0)
    if cut:
        mine = (local >= 0) & (local < E_l)
        keep = keep & mine
        local = torch.where(mine, local, 0)
        # f before what each rank computes in part: the tokens' inputs
        # and the gates, whose gradients are summed over the axis
        xf_in = copy_to_model(xf, model_axis)
        sorted_gate = copy_to_model(sorted_gate, model_axis)
    else:
        xf_in = xf
    slot = local * cap + torch.where(keep, rank, 0)              # [T*k]

    # every kept choice has a slot of its own; a dropped one (or one of
    # another rank's experts) adds zeros to a slot of its expert, so each
    # slot sums one value and zeros, the same bits in any order of the
    # adds (the card's index_add_ order is not fixed)
    gathered = torch.where(keep[:, None], xf_in[sorted_token],
                           torch.zeros((), dtype=dt, device=dev))
    buf = torch.zeros((E_l * cap, d), dtype=dt, device=dev).index_add(
        0, slot, gathered)
    out_buf = _expert_ffn(buf.reshape(E_l, cap, d), params).reshape(
        E_l * cap, d)

    contrib = out_buf[slot] * (sorted_gate * keep)[:, None].to(dt)
    # the combine: each token's top_k contributions are added into a zero
    # row one at a time in the reference's scatter order, ascending sorted
    # position, which is ascending expert id (the stable sort keeps a
    # token's k distinct experts in that order): gathered as [T, k, d],
    # then 0 + c_0 + c_1 + ... in the model dtype, the same bits on the
    # card and the CPU in every run (an unordered index_add_ would round
    # in another order at top_k > 2: DeepSeek-V2's 6).  Cut over the
    # model axis, another rank's experts add zeros, exactly, and the sum
    # over the axis adds the ranks' partial sums: at top_k = 2 (phi3.5-
    # MoE) a token's two experts sit on one rank (0 + a + b there, zeros
    # elsewhere) or on two (a on one, b on the other), so the bits of one
    # device hold; at a larger top_k the partial sums may round apart
    # from one device's order (no plan runs such a model yet)
    at = torch.empty_like(order)
    at[order] = torch.arange(T * k, device=dev)
    parts = contrib[torch.sort(at.view(T, k), dim=-1).values]   # [T, k, d]
    out = torch.zeros((T, d), dtype=dt, device=dev)
    for j in range(k):
        out = out + parts[:, j]
    if cut:
        out = reduce_from_model(out, model_axis)

    # ---- shared (always-on) experts ---------------------------------- #
    if m.n_shared_experts:
        shared_axis = model_axis if model_axis is not None \
            and model_axis.shared_experts else None
        out = out + apply_mlp(xf, {"w_gate": params["shared_gate"],
                                   "w_up": params["shared_up"],
                                   "w_down": params["shared_down"]}, "silu",
                              shared_axis)
    return out.reshape(B, S, d), aux
