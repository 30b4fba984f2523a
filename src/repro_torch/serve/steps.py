"""Serving steps on one device: counterparts of the reference's
``build_prefill_step``, ``build_serve_step``, ``build_insert_step`` and
``build_decode_slots_step`` (``repro/core/steps.py``).

PyTorch runs eagerly, so each step is a plain function rather than a
compiled one, and the caches the reference donates are updated in place
here.  Plans and meshes come with the plans item of the ROADMAP.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Cache, Model


@torch.no_grad()
def prefill_step(model: Model, params, batch, cache: Cache, *,
                 window: int = 0, last_pos=None):
    """(logits [B, V], filled cache).  ``last_pos`` (continuous
    batching) reads the logits of a bucket-padded prompt's true last
    token; the pad tail after it is causally invisible."""
    return model.prefill(params, batch, cache, window=window,
                         last_pos=last_pos)


@torch.no_grad()
def serve_step(model: Model, params, cache: Cache, tokens, *,
               window: int = 0):
    """One new token against the cache: (logits, greedy next token
    [B, 1] int32, cache)."""
    logits, cache = model.decode_step(params, cache, tokens, window=window)
    next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return logits, next_tok, cache


@torch.no_grad()
def decode_slots_step(model: Model, params, cache: Cache, tokens, live, *,
                      window: int = 0, pad_id: int = 0):
    """One decode step over the persistent slot cache.  Dead slots
    (``live`` False) emit ``pad_id`` and keep their ring index, so an
    evicted slot's state cannot drift before the insert that recycles
    it."""
    old_index = cache.index
    logits, new = model.decode_step(params, cache, tokens, window=window)
    new = new._replace(index=torch.where(live, new.index, old_index))
    next_tok = torch.where(live[:, None],
                           torch.argmax(logits, dim=-1)[:, None],
                           torch.full_like(live[:, None], pad_id,
                                           dtype=torch.long))
    return logits, next_tok.to(torch.int32), new


@torch.no_grad()
def insert_step(dst: Cache, src: Cache, slot: int, length: int) -> Cache:
    """Scatter a freshly prefilled batch-1 cache ``src`` into slot
    ``slot`` of the per-slot cache ``dst``, in place, and set the slot's
    index to the request's true ``length`` (the prefill cache holds the
    padded bucket length), so the pad tail stays masked and the next
    decode append overwrites its first position."""
    for name in dst._fields:
        d, s = getattr(dst, name), getattr(src, name)
        if name == "index":
            d[..., slot] = length
        else:                       # [L, B, ...] <- [L, 1, ...]
            d[:, slot] = s[:, 0]
    return dst
