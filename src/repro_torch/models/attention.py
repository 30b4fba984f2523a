"""Attention of the dense family and of the hybrid family's shared block
(port of the non-MLA part of ``repro/models/attention.py``):
full-sequence attention, decode over ring-buffered KV caches (fp32/bf16
or int8), and the GPT-2 biases.

Where the reference's jitted steps donate a cache and return a new one,
the port writes into the cache's tensors in place (``_append_token``,
``_ring_fill``) and returns a cache tuple over the same storage with a
new ``index`` tensor.

Kernels: on a CUDA tensor, full-sequence causal attention goes through
kernel A (``kernels/flash_attention.py``), forward and, when a gradient
is taken, backward, and int8-KV decode through kernel B
(``kernels/quantized.py``).  ``use_kernels=False`` runs their plain
PyTorch versions instead, with autograd through the plain attention (the
on-card parity checks of ``chip_smoke.py``); on the CPU the plain
versions always run, through the same autograd Function as the kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.quantized import int8kv_attention_plain
from repro_torch.models.layers import apply_rope, dense_init

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
    if use_kernels and q.is_cuda:
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


def decode_attention(q, k_cache, v_cache, valid_mask):
    """One-token attention.  q: [B, 1, H, Dk]; caches [B, S, KV, D*];
    valid_mask: [B, S] bool marking filled slots."""
    B, _, H, Dk = q.shape
    KV = k_cache.shape[2]
    group = H // KV
    qf = (q.float() * (1.0 / (Dk ** 0.5))).reshape(B, KV, group, Dk)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.float())
    s = s.masked_fill(~valid_mask[:, None, None, :], NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


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


def cache_append(cache: KVCache, k_new, v_new) -> KVCache:
    """Append one token (k_new/v_new: [B, 1, KV, D]) at the ring position,
    in place."""
    slot = torch.remainder(cache.index, cache.capacity)
    _append_token(cache.k, k_new, slot)
    _append_token(cache.v, v_new, slot)
    return KVCache(cache.k, cache.v, cache.index + 1)


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


def quant_cache_append(cache: QuantKVCache, k_new, v_new) -> QuantKVCache:
    """Quantize and append one token (k_new/v_new: [B, 1, KV, D]) in
    place."""
    slot = torch.remainder(cache.index, cache.capacity)
    kq, ks = _quant_kv(k_new)
    vq, vs = _quant_kv(v_new)
    _append_token(cache.k_q, kq, slot)
    _append_token(cache.k_scale, ks, slot)
    _append_token(cache.v_q, vq, slot)
    _append_token(cache.v_scale, vs, slot)
    return cache._replace(index=cache.index + 1)


def _ring_fill(buf, new, S: int):
    """Prefill a ring buffer leaf in place: keep the most recent
    ``capacity`` entries of ``new`` [B, S, ...] in slot = pos % capacity
    layout.  Returns ``buf``."""
    cap = buf.shape[1]
    if S >= cap:
        roll = -((S - cap) % cap) if cap else 0
        buf.copy_(torch.roll(new[:, S - cap:], roll, dims=1))
    else:
        buf[:, :S] = new
    return buf


def quant_cache_prefill(cache: QuantKVCache, k, v, S: int) -> QuantKVCache:
    """Fill the quantized cache from full-sequence k/v [B, S, KV, D]."""
    kq, ks = _quant_kv(k)
    vq, vs = _quant_kv(v)
    for buf, new in ((cache.k_q, kq), (cache.k_scale, ks),
                     (cache.v_q, vq), (cache.v_scale, vs)):
        _ring_fill(buf, new, S)
    return cache._replace(index=torch.full_like(cache.index, S))


def quant_decode_attention(q, cache: QuantKVCache, *,
                           use_kernels: bool = True):
    """One-token attention over the int8 cache.  Every cached token is in
    the past, so the fill mask alone (non-causal) gives
    ``decode_attention``'s semantics."""
    valid = cache.valid(q.shape[0]).contiguous()
    if use_kernels and q.is_cuda:
        return kernel_ops.flash_attention_int8kv(
            q, cache.k_q, cache.k_scale, cache.v_q, cache.v_scale, valid)
    return int8kv_attention_plain(q, cache.k_q, cache.k_scale, cache.v_q,
                                  cache.v_scale, valid)


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


def _out(o, params):
    dt = o.dtype
    y = o.flatten(2) @ params["wo"].to(dt).flatten(0, 1)
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
                      use_kernels: bool = True):
    """Full-sequence attention.  ``positions`` None means arange."""
    q, k, v = _qkv(x, params, cfg)
    q, k = _rope_qk(q, k, cfg, positions)
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          q_positions=positions, kv_positions=positions,
                          use_kernels=use_kernels)
    return _out(o, params)


def attention_prefill(x, params, cfg: ModelConfig, *,
                      positions: Optional[torch.Tensor] = None, cache,
                      window: int = 0, use_kernels: bool = True):
    """Prefill: full causal attention, and fill the cache (in place) with
    the prompt's k/v."""
    q, k, v = _qkv(x, params, cfg)
    q, k = _rope_qk(q, k, cfg, positions)
    o = chunked_attention(q, k, v, causal=True, window=window,
                          q_positions=positions, kv_positions=positions,
                          use_kernels=use_kernels)
    S = x.shape[1]
    if isinstance(cache, QuantKVCache):
        return _out(o, params), quant_cache_prefill(cache, k, v, S)
    _ring_fill(cache.k, k, S)
    _ring_fill(cache.v, v, S)
    return _out(o, params), KVCache(cache.k, cache.v,
                                    torch.full_like(cache.index, S))


def attention_decode(x, params, cfg: ModelConfig, *, cache,
                     window: int = 0, use_kernels: bool = True):
    """One-token decode: x [B, 1, d]."""
    B = x.shape[0]
    q, k, v = _qkv(x, params, cfg)
    q, k = _rope_qk(q, k, cfg, _decode_positions(cache.index)
                    if cfg.rope_theta else None)
    if isinstance(cache, QuantKVCache):
        cache = quant_cache_append(cache, k, v)
        o = quant_decode_attention(q, cache, use_kernels=use_kernels)
    else:
        cache = cache_append(cache, k, v)
        o = decode_attention(q, cache.k, cache.v, cache.valid(B))
    return _out(o, params), cache
