"""Attention of the dense and MoE families and of the hybrid family's
shared block (port of ``repro/models/attention.py``): full-sequence
attention, decode over ring-buffered KV caches (fp32/bf16 or int8), the
GPT-2 biases, and Multi-head Latent Attention (MiniCPM3, DeepSeek-V2:
full-sequence attention over per-head k and v decompressed from a
latent, and an absorbed-matmul decode over the ring-buffered latent
cache).

Where the reference's jitted steps donate a cache and return a new one,
the port writes into the cache's tensors in place (``_append_token``,
``_ring_fill``) and returns a cache tuple over the same storage with a
new ``index`` tensor.  One device is the case of one block of the ring
(``WHOLE_RING``) below.

Kernels: on a CUDA tensor, full-sequence causal attention goes through
kernel A (``kernels/flash_attention.py``), forward and, when a gradient
is taken, backward (MLA's at its split head dims, q and k of
``nope_head_dim + rope_head_dim`` over v of ``v_head_dim``, forward
only), int8-KV decode through kernel B (``kernels/quantized.py``), and
MLA's ``q_norm`` and ``kv_norm`` through kernel 6.  MLA's decode is
plain PyTorch, as the reference computes it outside any Pallas kernel.
``use_kernels=False`` runs their plain PyTorch versions instead, with
autograd through the plain attention (the on-card parity checks of
``chip_smoke.py``); on the CPU the plain versions always run, through
the same autograd Function as the kernels.

Under a plan that shards weights (``model_axis``), full-sequence
attention runs this rank's heads: the input enters through Megatron's
f, the output projection's partial sums are added over the ``model``
axis (g) before ``bo``.  When the kv heads do not divide the axis, wk
and wv stay whole: every rank projects all kv heads and its q heads
read their global kv head; the whole kv weights enter through f, so
their gradients, which each rank has only for its q heads, are summed
over the axis.

Serving under such a plan (``RingBlocks``, the layout of
``core.plans.Plan.cache_spec``) cuts each KV cache's ring over the
``model`` axis: a rank holds a block of consecutive slots of every KV
head.  Prefill attends over this rank's heads and fills the rank's block
from the whole-head k and v; decode gathers every head's q, k and v,
writes the token where its slot lies, attends over the block and merges
the ranks' partials by their log-sum-exp (``merge_blocks``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.core.sharding import (
    ModelAxis, all_gather, copy_to_model, reduce_from_model,
)
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.quantized import int8kv_attention_plain, live_lse
from repro_torch.models.layers import apply_norm, apply_rope, dense_init

NEG_INF = -1e30


# --------------------------------------------------------------------- #
# full-sequence attention
# --------------------------------------------------------------------- #

def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_positions=None, kv_positions=None,
                      q_chunk: int = 512, k_chunk: int = 1024,
                      use_kernels: bool = True):
    """q: [B, Sq, H, Dk]; k/v: [B, Sk, KV, D]; H % KV == 0.  Returns
    [B, Sq, H, Dv].

    With ``use_kernels`` and no positions (arange, the index masks) it
    is ``ops.flash_attention``: kernel A on a CUDA tensor, its plain
    version on a CPU one, through the autograd Function when a gradient
    is taken.  Otherwise it is the reference's chunked online-softmax
    path with its position masks, differentiated by autograd.  On a CUDA
    tensor explicit positions raise on the kernel path instead of being
    dropped, as the reference's kernel path drops them
    (``repro/models/attention.py:52-55``)."""
    if use_kernels and q_positions is None and kv_positions is None:
        return kernel_ops.flash_attention(q, k, v, causal=causal,
                                          window=window)
    if use_kernels and q.device.type != "cpu":      # the card, or meta
        raise ValueError(
            "flash kernel A masks by sequence index; explicit "
            "positions are not supported on the kernel path (pass "
            "use_kernels=False to attend by position)")
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_positions=q_positions,
                                 kv_positions=kv_positions,
                                 q_chunk=q_chunk, k_chunk=k_chunk)


# --------------------------------------------------------------------- #
# decode attention over a (possibly ring-buffered) KV cache
# --------------------------------------------------------------------- #

def _ring_valid(index, batch: int, capacity: int):
    """Filled-slot mask [batch, capacity] for a scalar (shared) or
    per-slot ``[batch]`` ring index."""
    slots = torch.arange(capacity, dtype=torch.int32, device=index.device)
    filled = torch.clamp(index, max=capacity)
    if index.dim() == 0:
        return (slots[None, :] < filled).expand(batch, capacity)
    return slots[None, :] < filled[:, None]


def _append_token(buf, new, slot):
    """Write one token's row (``new``: [B, 1, ...]) into ``buf``
    ([B, S, ...]) in place at ring position ``slot``: a scalar tensor
    (shared) or per-slot ``[B]``.  Returns ``buf``."""
    new = new.to(buf.dtype)
    if slot.dim() == 0:
        buf.index_copy_(1, slot.reshape(1).long(), new)
    else:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot.long()] = new[:, 0]
    return buf


def _decode_positions(index):
    """Positions [*, 1] of the token being decoded."""
    return index[None, None] if index.dim() == 0 else index[:, None]


def decode_attention(q, k_cache, v_cache, valid_mask, *,
                     with_lse: bool = False):
    """One-token attention.  q: [B, 1, H, Dk]; caches [B, S, KV, D*];
    valid_mask: [B, S] bool marking filled slots.  ``with_lse`` also
    returns each (row, head)'s log-sum-exp of its filled slots' scores,
    fp32 [B, H], -inf for a row with none (``live_lse``)."""
    B, _, H, Dk = q.shape
    KV = k_cache.shape[2]
    group = H // KV
    qf = (q.float() * (1.0 / (Dk ** 0.5))).reshape(B, KV, group, Dk)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    s = s.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    out = out.reshape(B, 1, H, -1).to(q.dtype)
    if not with_lse:
        return out
    return out, live_lse(s.reshape(B, H, -1), valid_mask)


class KVCache(NamedTuple):
    """Ring-buffered KV cache (window=0 => plain cache of full length)."""
    k: torch.Tensor          # [B, S, KV, Dk]
    v: torch.Tensor          # [B, S, KV, Dv]
    index: torch.Tensor      # int32 next write position: scalar or [B]

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    def valid(self, batch: int):
        return _ring_valid(self.index, batch, self.capacity)


def init_kv_cache(batch: int, capacity: int, kv_heads: int, dk: int, dv: int,
                  dtype, *, lead=(), device="cpu") -> KVCache:
    lead = tuple(lead)
    return KVCache(
        k=torch.zeros(lead + (batch, capacity, kv_heads, dk), dtype=dtype,
                      device=device),
        v=torch.zeros(lead + (batch, capacity, kv_heads, dv), dtype=dtype,
                      device=device),
        index=torch.zeros(lead, dtype=torch.int32, device=device))


# --------------------------------------------------------------------- #
# int8-quantized KV cache: per-(token, kv-head) absmax scales over
# head_dim; decode attends through kernel B
# --------------------------------------------------------------------- #

class QuantKVCache(NamedTuple):
    """Ring-buffered int8 KV cache with one fp32 scale per (token,
    kv-head)."""
    k_q: torch.Tensor        # [B, S, KV, Dk] int8
    k_scale: torch.Tensor    # [B, S, KV] fp32
    v_q: torch.Tensor        # [B, S, KV, Dv] int8
    v_scale: torch.Tensor    # [B, S, KV] fp32
    index: torch.Tensor      # int32 next write position: scalar or [B]

    @property
    def capacity(self) -> int:
        return self.k_q.shape[1]

    def valid(self, batch: int):
        return _ring_valid(self.index, batch, self.capacity)


def init_quant_kv_cache(batch: int, capacity: int, kv_heads: int, dk: int,
                        dv: int, *, lead=(), device="cpu") -> QuantKVCache:
    lead = tuple(lead)
    shape = lead + (batch, capacity, kv_heads)
    return QuantKVCache(
        k_q=torch.zeros(shape + (dk,), dtype=torch.int8, device=device),
        k_scale=torch.ones(shape, dtype=torch.float32, device=device),
        v_q=torch.zeros(shape + (dv,), dtype=torch.int8, device=device),
        v_scale=torch.ones(shape, dtype=torch.float32, device=device),
        index=torch.zeros(lead, dtype=torch.int32, device=device))


def _quant_kv(x):
    """[B, S, KV, D] fp -> (int8 payload, [B, S, KV] fp32 scales): one
    absmax block over the whole head_dim per (token, kv-head)."""
    q, s = kernel_ops.quantize(x, block=x.shape[-1], axis=-1)
    return q, s[..., 0]


# --------------------------------------------------------------------- #
# standard GQA attention parameters
# --------------------------------------------------------------------- #

def init_attention(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(generator, (d, H, hd), d, **kw),
        "wk": dense_init(generator, (d, KV, hd), d, **kw),
        "wv": dense_init(generator, (d, KV, hd), d, **kw),
        "wo": dense_init(generator, (H, hd, d), H * hd, **kw),
    }
    if cfg.norm == "layernorm":  # gpt2-style attention biases
        lead = tuple(lead)
        p["bq"] = torch.zeros(lead + (H, hd), device=device)
        p["bk"] = torch.zeros(lead + (KV, hd), device=device)
        p["bv"] = torch.zeros(lead + (KV, hd), device=device)
        p["bo"] = torch.zeros(lead + (d,), device=device)
    return p


def _proj(x, w):
    """[B, S, d] x [d, heads, hd] -> [B, S, heads, hd] (one matmul)."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _qkv(x, params, cfg: ModelConfig):
    dt = x.dtype
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def _qkv_cut(x, params, cfg: ModelConfig, axis: ModelAxis, *,
             whole_kv: bool = False):
    """``_qkv`` of this rank's q heads under a weight-sharding plan: k
    and v of its kv heads where the plan cuts them; otherwise of every
    kv head with ``whole_kv``, else of each local q head's kv head."""
    x = copy_to_model(x, axis)
    if axis.kv_heads:
        return _qkv(x, params, cfg)
    whole = dict(params)
    for name in ("wk", "wv", "bk", "bv"):
        if name in whole:
            whole[name] = copy_to_model(whole[name], axis)
    q, k, v = _qkv(x, whole, cfg)
    if whole_kv:
        return q, k, v
    return (q,) + _kv_of_heads(k, v, cfg, axis, q.shape[2])


def _kv_of_heads(k, v, cfg: ModelConfig, axis: ModelAxis, h_local: int):
    """Of every kv head's k and v, the kv head of each of this rank's
    ``h_local`` q heads: global head // (H // KV)."""
    heads = torch.arange(h_local, device=k.device) + axis.rank * h_local
    kv = heads // (cfg.n_heads // cfg.n_kv_heads)
    return k.index_select(2, kv), v.index_select(2, kv)


def _out(o, params, model_axis: Optional[ModelAxis] = None):
    dt = o.dtype
    y = o.flatten(2) @ params["wo"].to(dt).flatten(0, 1)
    if model_axis is not None:
        y = reduce_from_model(y, model_axis)
    if "bo" in params:
        y = y + params["bo"].to(dt)
    return y


def _rope_qk(q, k, cfg: ModelConfig, positions):
    if not cfg.rope_theta:
        return q, k
    if positions is None:
        positions = torch.arange(q.shape[1], device=q.device)[None]
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def attention_forward(x, params, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor] = None,
                      causal: bool = True, window: int = 0,
                      use_kernels: bool = True,
                      model_axis: Optional[ModelAxis] = None):
    """Full-sequence attention.  ``positions`` None means arange.
    ``model_axis``: the heads are cut over it when its ``heads`` is set;
    otherwise every rank computes them all."""
    if model_axis is not None and not model_axis.heads:
        model_axis = None
    if model_axis is None:
        q, k, v = _qkv(x, params, cfg)
    else:
        q, k, v = _qkv_cut(x, params, cfg, model_axis)
    q, k = _rope_qk(q, k, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          q_positions=positions, kv_positions=positions,
                          use_kernels=use_kernels)
    return _out(o, params, model_axis)


# --------------------------------------------------------------------- #
# prefill and decode over a cache whose ring may be cut into blocks over
# the ``model`` axis (serving under a plan); one device holds one block
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class RingBlocks:
    """Where a rank's ring slots lie under a serving plan: the ring of
    every KV head is cut into ``size`` blocks of ``c`` consecutive slots
    over ``group`` (the ``model`` axis, ``Plan.cache_spec``'s cut of the
    dim after batch), this rank holding block ``rank``, slots ``[rank *
    c, (rank + 1) * c)``, ``c`` its cache's capacity.  ``group`` None:
    the ring whole on every rank, one block (``WHOLE_RING``)."""
    group: Any
    size: int
    rank: int


WHOLE_RING = RingBlocks(group=None, size=1, rank=0)


def _gather_heads(ts, axis: ModelAxis):
    """Each of ``ts`` ([B, S, w, D], this rank's heads) whole over the
    heads of the ``model`` axis, in rank order, all through one
    all-gather."""
    widths = [t.shape[2] for t in ts]
    every = all_gather(torch.cat(ts, 2), axis.group, 0).unflatten(
        0, (axis.size, -1))                      # [n, B, S, sum w, D]
    out, at = [], 0
    for w in widths:
        out.append(every[:, :, :, at:at + w].permute(1, 2, 0, 3, 4)
                   .flatten(2, 3))
        at += w
    return out


def _heads(x, params, cfg: ModelConfig, axis: Optional[ModelAxis]):
    """(q, k, v, heads cut): q of this rank's heads where the plan cuts
    them, k and v of its kv heads where it cuts those, else every
    head's."""
    if axis is not None and axis.heads:
        return _qkv_cut(x, params, cfg, axis, whole_kv=True) + (True,)
    return _qkv(x, params, cfg) + (False,)


def _ring_fill(buf, new, S: int, blocks: RingBlocks):
    """Fill this rank's block ``buf`` [B, c, ...] of a ring buffer leaf
    in place: of the ring the whole prompt ``new`` [B, S, ...] gives (its
    last ``capacity`` entries in slot = pos % capacity layout), slots
    ``[rank c, (rank + 1) c)``.  Returns ``buf``."""
    c = buf.shape[1]
    lo, cap = blocks.rank * c, blocks.size * c
    if S >= cap:
        ring = torch.roll(new[:, S - cap:], -((S - cap) % cap), dims=1)
        buf.copy_(ring[:, lo:lo + c])
    elif S > lo:
        n = min(S, lo + c) - lo
        buf[:, :n] = new[:, lo:lo + n]
    return buf


def attention_prefill(x, params, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor] = None, cache,
                      window: int = 0, use_kernels: bool = True,
                      model_axis: Optional[ModelAxis] = None,
                      blocks: RingBlocks = WHOLE_RING):
    """Prefill: full causal attention, and fill the cache (in place) with
    the prompt's k/v.  Under a serving plan the prompt's attention runs
    over this rank's heads (``model_axis``; kernel A), as the training
    forward runs it, and the whole-head k and v (gathered over the heads
    where the plan cuts the kv heads) fill this rank's block of the ring
    (``blocks``), int8 quantized from the whole heads, so that payloads
    and scales are the one-device ones."""
    axis = model_axis
    q, k, v, cut = _heads(x, params, cfg, axis)
    q, k = _rope_qk(q, k, cfg, positions)
    k_att, v_att = k, v
    if cut and axis.kv_heads:
        k, v = _gather_heads([k, v], axis)
    elif cut:
        k_att, v_att = _kv_of_heads(k, v, cfg, axis, q.shape[2])
    o = chunked_attention(q, k_att, v_att, causal=True, window=window,
                          q_positions=positions, kv_positions=positions,
                          use_kernels=use_kernels)
    S = x.shape[1]
    if isinstance(cache, QuantKVCache):
        (kq, ks), (vq, vs) = _quant_kv(k), _quant_kv(v)
        fills = ((cache.k_q, kq), (cache.k_scale, ks), (cache.v_q, vq),
                 (cache.v_scale, vs))
    else:
        fills = ((cache.k, k), (cache.v, v))
    for buf, new in fills:
        _ring_fill(buf, new, S, blocks)
    return (_out(o, params, axis if cut else None),
            cache._replace(index=torch.full_like(cache.index, S)))


def _append_block(cache, k_new, v_new, blocks: RingBlocks):
    """Append one token (whole-head k_new/v_new: [B, 1, KV, D]) at its
    ring slot, index % capacity, in place: the rank whose block holds a
    row's slot writes it (one block: every row, as ``_append_token``
    writes it).  Returns (cache with index + 1, [B, c] fill mask of this
    rank's block)."""
    c = cache.capacity
    lo, cap = blocks.rank * c, blocks.size * c
    slot = torch.remainder(cache.index, cap)
    if isinstance(cache, QuantKVCache):
        (kq, ks), (vq, vs) = _quant_kv(k_new), _quant_kv(v_new)
        writes = ((cache.k_q, kq), (cache.k_scale, ks), (cache.v_q, vq),
                  (cache.v_scale, vs))
    else:
        writes = ((cache.k, k_new), (cache.v, v_new))
    if blocks.size == 1:
        for buf, new in writes:
            _append_token(buf, new, slot)
    else:
        # the rows whose slot lies in [lo, lo + c); the others keep what
        # their slot held
        B = k_new.shape[0]
        rows = torch.arange(B, device=slot.device)
        local = (slot - lo).expand(B)
        own = (local >= 0) & (local < c)
        at = torch.clamp(local, 0, c - 1).long()
        for buf, new in writes:
            keep = own.view((B,) + (1,) * (buf.dim() - 2))
            buf[rows, at] = torch.where(keep, new[:, 0].to(buf.dtype),
                                        buf[rows, at])
    index = cache.index + 1
    valid = _ring_valid(index, k_new.shape[0], cap)[:, lo:lo + c]
    return cache._replace(index=index), valid.contiguous()


def merge_partials(o, lse):
    """The attention over the union of ``n`` disjoint sets of keys from
    each set's partial: ``o`` [n, B, H, D] (fp32) over set r and ``lse``
    [n, B, H] its log-sum-exp, merged in order r = 0, 1, ... in fp32,
    o = sum_r exp(lse_r - m) o_r / sum_r exp(lse_r - m) with m the
    largest lse, so that reruns are bit-equal.  A set with no live key
    has lse -inf and weight 0 (one set must hold one); one set merges
    to itself exactly.  Returns [B, H, D] fp32."""
    w = torch.exp(lse - lse.amax(0))
    num, den = w[0, ..., None] * o[0], w[0]
    for r in range(1, o.shape[0]):
        num = num + w[r, ..., None] * o[r]
        den = den + w[r]
    return num / den[..., None]


def merge_blocks(o, lse, blocks: RingBlocks):
    """One-token attention over a ring cut into blocks, from this rank's
    partial over its block, ``o`` [B, 1, H, D] and ``lse`` [B, H]: the
    ranks' partials all-gathered over ``blocks.group`` (one collective)
    and merged in rank order (``merge_partials``; a row's own token is
    always filled, so some block holds a live key)."""
    parts = torch.cat([o[:, 0].float(), lse[..., None]], -1)  # [B, H, D+1]
    parts = all_gather(parts, blocks.group, 0).unflatten(
        0, (blocks.size, -1))
    return merge_partials(parts[..., :-1], parts[..., -1]).to(
        o.dtype)[:, None]


def attention_decode(x, params, cfg: ModelConfig, *, cache,
                     window: int = 0, use_kernels: bool = True,
                     model_axis: Optional[ModelAxis] = None,
                     blocks: RingBlocks = WHOLE_RING):
    """One-token decode: x [B, 1, d].  The token's k and v are written at
    its ring slot and q attends over the filled slots (kernel B for the
    int8 cache on the card).  Under a serving plan each rank projects its
    heads' q, k and v (``model_axis``) and the ranks gather every head's
    (one all-gather); the rank whose block (``blocks``) holds a row's
    slot writes its k and v; each rank attends with every head over its
    block's filled slots, and the partials merge by their log-sum-exp
    (``merge_blocks``; a ring whole on every rank is one block, whose
    partial needs no merge); a rank keeps its heads for ``wo``.
    ``window`` is the ring's: the cache's capacity."""
    axis = model_axis
    q, k, v, cut = _heads(x, params, cfg, axis)
    q, k = _rope_qk(q, k, cfg, _decode_positions(cache.index)
                    if cfg.rope_theta else None)
    h_local = q.shape[2]
    if cut and axis.kv_heads:
        q, k, v = _gather_heads([q, k, v], axis)
    elif cut:
        (q,) = _gather_heads([q], axis)
    cache, valid = _append_block(cache, k, v, blocks)
    # a ring whole on every rank is one block: its partial is the answer
    lse = blocks.group is not None
    if not isinstance(cache, QuantKVCache):
        o = decode_attention(q, cache.k, cache.v, valid, with_lse=lse)
    elif use_kernels and q.device.type != "cpu":    # the card, or meta
        o = kernel_ops.flash_attention_int8kv(
            q, cache.k_q, cache.k_scale, cache.v_q, cache.v_scale, valid,
            with_lse=lse)
    else:
        o = int8kv_attention_plain(q, cache.k_q, cache.k_scale, cache.v_q,
                                   cache.v_scale, valid, with_lse=lse)
    if lse:
        o = merge_blocks(*o, blocks)
    if cut:
        o = o[:, :, axis.rank * h_local:(axis.rank + 1) * h_local]
    return _out(o, params, axis if cut else None), cache


# --------------------------------------------------------------------- #
# Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2), one device: the
# plans refuse it (ROADMAP queue 1, item 13)
# --------------------------------------------------------------------- #

class MLACache(NamedTuple):
    """Ring-buffered latent cache: per token the ``kv_lora_rank`` latent
    and the decoupled rope key, shared by every head (MLA's memory
    win over a KV cache of ``2 * n_heads * head_dim`` a token)."""
    c_kv: torch.Tensor       # [B, S, R] latent
    k_rope: torch.Tensor     # [B, S, rope_head_dim]
    index: torch.Tensor      # int32 next write position: scalar or [B]

    @property
    def capacity(self) -> int:
        return self.c_kv.shape[1]

    def valid(self, batch: int):
        return _ring_valid(self.index, batch, self.capacity)


def init_mla_cache(batch: int, capacity: int, mla: MLAConfig, dtype, *,
                   lead=(), device="cpu") -> MLACache:
    lead = tuple(lead)
    return MLACache(
        c_kv=torch.zeros(lead + (batch, capacity, mla.kv_lora_rank),
                         dtype=dtype, device=device),
        k_rope=torch.zeros(lead + (batch, capacity, mla.rope_head_dim),
                           dtype=dtype, device=device),
        index=torch.zeros(lead, dtype=torch.int32, device=device))


def init_mla(generator, cfg: ModelConfig, *, lead=(), device="cpu"):
    """The reference's MLA leaves, shapes and laws: a low-rank query
    (``w_dq``, ``q_norm``) when ``q_lora_rank`` is set, the query's
    up-projection ``w_uq`` to nope + rope dims a head, the latent's
    down-projection ``w_dkv`` and ``kv_norm``, the shared rope key
    ``w_kr``, the per-head up-projections ``w_uk`` and ``w_uv`` and
    ``wo``."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    kw = dict(lead=lead, device=device)
    lead = tuple(lead)
    p = {}
    q_in = d
    if m.q_lora_rank:
        p["w_dq"] = dense_init(generator, (d, m.q_lora_rank), d, **kw)
        p["q_norm"] = torch.ones(lead + (m.q_lora_rank,), device=device)
        q_in = m.q_lora_rank
    p["w_uq"] = dense_init(generator,
                           (q_in, H, m.nope_head_dim + m.rope_head_dim),
                           q_in, **kw)
    p["w_dkv"] = dense_init(generator, (d, m.kv_lora_rank), d, **kw)
    p["kv_norm"] = torch.ones(lead + (m.kv_lora_rank,), device=device)
    p["w_kr"] = dense_init(generator, (d, m.rope_head_dim), d, **kw)
    p["w_uk"] = dense_init(generator, (H, m.kv_lora_rank, m.nope_head_dim),
                           m.kv_lora_rank, **kw)
    p["w_uv"] = dense_init(generator, (H, m.kv_lora_rank, m.v_head_dim),
                           m.kv_lora_rank, **kw)
    p["wo"] = dense_init(generator, (H, m.v_head_dim, d), H * m.v_head_dim,
                         **kw)
    return p


def _mla_q(x, params, cfg: ModelConfig, positions, use_kernels: bool):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope] rotated)."""
    m, dt = cfg.mla, x.dtype
    if "w_dq" in params:
        cq = apply_norm(x @ params["w_dq"].to(dt), {"scale": params["q_norm"]},
                        "rmsnorm", cfg.norm_eps, use_kernels=use_kernels)
    else:
        cq = x
    q = _proj(cq, params["w_uq"])
    return (q[..., :m.nope_head_dim],
            apply_rope(q[..., m.nope_head_dim:], positions, cfg.rope_theta))


def _mla_latent(x, params, cfg: ModelConfig, positions, use_kernels: bool):
    """(c_kv [B, S, R] normed, k_rope [B, S, rope] rotated): what the
    cache keeps."""
    dt = x.dtype
    c_kv = apply_norm(x @ params["w_dkv"].to(dt), {"scale": params["kv_norm"]},
                      "rmsnorm", cfg.norm_eps, use_kernels=use_kernels)
    k_rope = apply_rope((x @ params["w_kr"].to(dt))[:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_full(x, params, cfg: ModelConfig, positions, window: int,
              use_kernels: bool):
    """(output, c_kv, k_rope) of full-sequence MLA: each head's k and v
    decompressed from the latent, k with the shared rope key, causal
    attention at (Dk, Dv) = (nope + rope, v_head_dim), kernel A on the
    card, then ``wo``.  ``positions`` None means arange, the index masks
    kernel A takes."""
    pos = torch.arange(x.shape[1], device=x.device)[None] \
        if positions is None else positions
    q_nope, q_rope = _mla_q(x, params, cfg, pos, use_kernels)
    c_kv, k_rope = _mla_latent(x, params, cfg, pos, use_kernels)
    dt = x.dtype
    B, S, H, _ = q_nope.shape
    k_nope = torch.einsum("bsr,hrk->bshk", c_kv, params["w_uk"].to(dt))
    v = torch.einsum("bsr,hrk->bshk", c_kv, params["w_uv"].to(dt))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, k_rope.shape[-1])], dim=-1)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          q_positions=positions, kv_positions=positions,
                          use_kernels=use_kernels)
    return _out(o, params), c_kv, k_rope


def mla_forward(x, params, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None, window: int = 0,
                use_kernels: bool = True):
    """Full-sequence MLA (training)."""
    return _mla_full(x, params, cfg, positions, window, use_kernels)[0]


def mla_prefill(x, params, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None, cache: MLACache,
                window: int = 0, use_kernels: bool = True):
    """``mla_forward``, and the prompt's latent and rope key fill the
    cache in place (the last ``capacity`` of them in slot = pos %
    capacity layout when the prompt is longer, as the reference rolls
    them).  The latent is computed once, where the reference computes it
    again for the cache: the same values, and one ``kv_norm`` a layer."""
    out, c_kv, k_rope = _mla_full(x, params, cfg, positions, window,
                                  use_kernels)
    S = x.shape[1]
    _ring_fill(cache.c_kv, c_kv, S, WHOLE_RING)
    _ring_fill(cache.k_rope, k_rope, S, WHOLE_RING)
    return out, cache._replace(index=torch.full_like(cache.index, S))


def mla_decode(x, params, cfg: ModelConfig, *, cache: MLACache,
               window: int = 0, use_kernels: bool = True):
    """Absorbed-matmul decode of one token x [B, 1, d]: its latent and
    rope key are written at its ring slot (in place), and the scores are
    computed in latent space, ``(q_nope W_uk) c_kv^T + q_rope k_rope^T``
    in fp32 over the filled slots, so no head's k or v is ever
    decompressed; the context comes back through ``W_uv`` and ``wo``.
    ``window`` is the ring's: the cache's capacity."""
    m, dt = cfg.mla, x.dtype
    B = x.shape[0]
    pos = _decode_positions(cache.index)
    q_nope, q_rope = _mla_q(x, params, cfg, pos, use_kernels)    # [B,1,H,*]
    c_new, r_new = _mla_latent(x, params, cfg, pos, use_kernels)
    slot = torch.remainder(cache.index, cache.capacity)
    _append_token(cache.c_kv, c_new, slot)
    _append_token(cache.k_rope, r_new, slot)
    cache = cache._replace(index=cache.index + 1)
    q_lat = torch.einsum("bqhk,hrk->bqhr", q_nope, params["w_uk"].to(dt))
    # a host scalar: a tensor made on the host here would cost a copy to
    # the card, and a wait for its stream, every layer of every step
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    c_kv = cache.c_kv.float()
    s = torch.einsum("bqhr,bsr->bhqs", q_lat.float(), c_kv)
    s = s + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                         cache.k_rope.float())
    s = (s * scale).masked_fill(~cache.valid(B)[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bqhr", w, c_kv)
    o = torch.einsum("bqhr,hrk->bqhk", ctx.to(dt), params["w_uv"].to(dt))
    return _out(o, params), cache
