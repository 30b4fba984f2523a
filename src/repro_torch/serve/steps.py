"""Serving steps on one device: counterparts of the reference's
``build_prefill_step``, ``build_serve_step``, ``build_insert_step`` and
``build_decode_slots_step`` (``repro/core/steps.py``).

PyTorch runs eagerly, so each step is a plain function rather than a
compiled one, and the caches the reference donates are updated in place
here.  A cache is any structure of NamedTuples and dicts of tensors (a
KV cache, an SSM state, the hybrid family's ``{"ssm", "attn"}`` dict);
the slot steps walk it with ``map_cache`` and treat the leaves named
``index`` (ring fill positions) apart.  Plans and meshes come with the
plans item of the ROADMAP.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Cache, Model, map_cache


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
    (``live`` False) emit ``pad_id`` and keep their ring indices (the
    leaves named ``index``), so an evicted slot's KV ring cannot move
    before the insert that recycles it.  Its SSM state may drift, as in
    the reference: the insert overwrites it."""
    logits, new = model.decode_step(params, cache, tokens, window=window)
    # decode made new index tensors; ``cache`` still holds the old ones
    new = map_cache(lambda name, n, o: torch.where(live, n, o)
                    if name == "index" else n, new, cache)
    next_tok = torch.where(live[:, None],
                           torch.argmax(logits, dim=-1)[:, None],
                           torch.full_like(live[:, None], pad_id,
                                           dtype=torch.long))
    return logits, next_tok.to(torch.int32), new


@torch.no_grad()
def insert_step(dst: Cache, src: Cache, slot: int, length: int) -> Cache:
    """Scatter a freshly prefilled batch-1 cache ``src`` into slot
    ``slot`` of the per-slot cache ``dst``, in place, and set the slot's
    ring indices to the request's true ``length`` (the prefill cache
    holds the padded bucket length), so the pad tail stays masked and the
    next decode append overwrites its first position.

    As the reference's ``build_insert_step`` does, a leaf's batch axis is
    the first axis on which ``dst`` and ``src`` differ in size: 1 for
    ``[L, B, ...]`` leaves, 2 for the hybrid family's ``[G, k, B, ...]``
    SSM state.  With one slot the shapes agree and the whole leaf is
    the slot."""
    def put(name, d, s):
        if name == "index":
            d[..., slot] = length
            return d
        axis = next((i for i, (m, n) in enumerate(zip(d.shape, s.shape))
                     if m != n), None)
        if axis is None:
            d.copy_(s)
        else:
            d.select(axis, slot).copy_(s.select(axis, 0))
        return d

    return map_cache(put, dst, src)
