"""Model assembly for the dense family (port of ``repro/models/model.py``):
embeddings -> stacked layers -> head, with forward, prefill and decode.

Layer parameters and caches keep the reference's stacked ``[L, ...]``
layout; where the reference scans over the stack, the port runs a Python
loop over layer slices.  Caches are updated in place (the reference
donates them to its jitted steps instead).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models.layers import (
    apply_norm, embed, init_embedding, init_learned_positions, init_norm,
    unembed,
)

Params = Dict[str, Any]
Cache = Union[attn_mod.KVCache, attn_mod.QuantKVCache]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked parameter dict (every leaf indexed on its
    leading axis; views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


class Model:
    """Functional dense model around a ModelConfig.

    ``device`` defaults to "cuda" and raises when no card is present.
    ``use_kernels=False`` runs the kernels' plain PyTorch versions on
    the card too (the reference's ``use_pallas`` flag, inverted in
    default: the port's main path is the kernel path)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 use_kernels: bool = True):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue "
                f"1, item 10); the port serves the dense family")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.compute_dtype = _DTYPES[cfg.dtype]

    # ----------------------------------------------------------------- #
    def init(self, generator: torch.Generator) -> Params:
        """Fresh fp32 params with the reference's shapes and init laws.
        ``generator`` must live on the model's device type."""
        cfg, dev = self.cfg, self.device
        params: Params = {
            "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                    device=dev),
            "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_embedding(generator, cfg.vocab_size,
                                               cfg.d_model, device=dev)
        if not cfg.rope_theta:
            params["pos_embed"] = init_learned_positions(
                generator, cfg.max_seq_len, cfg.d_model, device=dev)
        params["layers"] = blocks.init_dense_block(
            generator, cfg, lead=(cfg.n_layers,), device=dev)
        return params

    # ----------------------------------------------------------------- #
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    Optional[torch.Tensor]]:
        """Returns (x, positions); positions stay None when the batch
        gives none (arange, the serving case the flash kernel takes)."""
        dt = self.compute_dtype
        tokens = self._tokens(batch["tokens"])
        x = embed(tokens, params["embed"], dt)
        positions = batch.get("positions")
        if positions is not None:
            positions = torch.as_tensor(positions, device=self.device)
        if "pos_embed" in params:
            table = params["pos_embed"]["table"]
            pe = table[positions.long()] if positions is not None \
                else table[: x.shape[1]][None]
            x = x + pe.to(dt)
        return x, positions

    def _head(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return unembed(x, table, self.compute_dtype)

    # ----------------------------------------------------------------- #
    def forward(self, params, batch, *, window: int = 0) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (fp32)."""
        x, positions = self._embed_inputs(params, batch)
        for i in range(self.cfg.n_layers):
            x = blocks.dense_block_forward(
                x, layer_slice(params["layers"], i), self.cfg,
                positions=positions, window=window,
                use_kernels=self.use_kernels)
        return self._head(params, x)

    # ----------------------------------------------------------------- #
    def init_cache(self, batch: int, capacity: int, *, window: int = 0,
                   kv_dtype: str = "fp32") -> Cache:
        """Decode cache, leaves stacked on the layer axis; index [L].
        ``kv_dtype='fp32'`` keeps k/v in the compute dtype (the
        reference's name); 'int8' is the quantized cache decode runs
        through kernel B."""
        cfg = self.cfg
        cap = min(capacity, window) if window else capacity
        lead = (cfg.n_layers,)
        if kv_dtype == "int8":
            return attn_mod.init_quant_kv_cache(
                batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                lead=lead, device=self.device)
        if kv_dtype == "fp32":
            return attn_mod.init_kv_cache(
                batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                self.compute_dtype, lead=lead, device=self.device)
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected 'fp32' "
                         f"or 'int8'")

    def init_slot_cache(self, batch: int, capacity: int, *, window: int = 0,
                        kv_dtype: str = "fp32") -> Cache:
        """Per-slot cache for continuous batching: ``init_cache`` with the
        index widened to [L, batch], one fill position per slot."""
        cache = self.init_cache(batch, capacity, window=window,
                                kv_dtype=kv_dtype)
        return cache._replace(index=torch.zeros(
            (self.cfg.n_layers, batch), dtype=torch.int32,
            device=self.device))

    @staticmethod
    def _cache_layer(cache: Cache, i: int) -> Cache:
        return type(cache)(*(leaf[i] for leaf in cache))

    @staticmethod
    def _restack(cache: Cache, layer_caches) -> Cache:
        """The stacked cache after a pass: its tensors were written in
        place; only the per-layer indices are new."""
        return cache._replace(
            index=torch.stack([c.index for c in layer_caches]))

    # ----------------------------------------------------------------- #
    def prefill(self, params, batch, cache: Cache, *, window: int = 0,
                last_pos=None) -> Tuple[torch.Tensor, Cache]:
        """Returns (logits [B, V] at the last position, or at ``last_pos``
        for a bucket-padded prompt; filled cache)."""
        x, positions = self._embed_inputs(params, batch)
        new = []
        for i in range(self.cfg.n_layers):
            x, c = blocks.dense_block_prefill(
                x, layer_slice(params["layers"], i), self.cfg,
                positions=positions, cache=self._cache_layer(cache, i),
                window=window, use_kernels=self.use_kernels)
            new.append(c)
        if last_pos is None:
            last_pos = x.shape[1] - 1
        x_last = x[:, last_pos:last_pos + 1]
        return self._head(params, x_last)[:, 0], self._restack(cache, new)

    def decode_step(self, params, cache: Cache, tokens, *, window: int = 0
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, 1] -> (logits [B, V], cache advanced one token)."""
        cfg, dt = self.cfg, self.compute_dtype
        x = embed(self._tokens(tokens), params["embed"], dt)
        if "pos_embed" in params:
            pos = self._cache_index(cache)
            pe = params["pos_embed"]["table"][
                torch.clamp(pos, 0, cfg.max_seq_len - 1).long()].to(dt)
            x = x + (pe[None, None] if pos.dim() == 0 else pe[:, None])
        new = []
        for i in range(cfg.n_layers):
            x, c = blocks.dense_block_decode(
                x, layer_slice(params["layers"], i), cfg,
                cache=self._cache_layer(cache, i), window=window,
                use_kernels=self.use_kernels)
            new.append(c)
        return self._head(params, x)[:, 0], self._restack(cache, new)

    @staticmethod
    def _cache_index(cache: Cache) -> torch.Tensor:
        """Current absolute position: layer 0's index (scalar, or [B] for
        a per-slot cache)."""
        return cache.index[0]
