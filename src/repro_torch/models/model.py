"""Model assembly for the dense, MoE, SSM, hybrid, encoder-decoder and
vision-language families (port of ``repro/models/model.py``):
embeddings -> stacked layers -> head, with forward, loss, prefill and
decode.  The MoE family's per-layer
load-balance losses are summed over the stack into ``Model.loss``, as
the reference's ``run_stack`` sums them; serving ignores them.

Layer parameters and caches keep the reference's stacked layout:
``[L, ...]``, and for the hybrid family ``layers/blocks`` as ``[G, k,
...]`` (G groups of k Mamba2 layers), ``layers/gates`` as ``[G]`` and one
``shared`` dense block applied at the head of every group.  The
encoder-decoder family (whisper) adds ``encoder/layers`` [L_enc, ...],
``encoder/norm`` and ``encoder/pos/table``: ``_encode`` runs the encoder
over a batch's ``frames`` once a forward pass (or prefill), and every
decoder layer attends over its output.  The vision-language family
(phi-3-vision) is the dense stack behind a ``projector`` (``w1``
[vision_dim, d], ``w2`` [d, d]): a batch's precomputed ``patch_embeds``
[B, P, vision_dim] go through ``w1``, the tanh GELU in fp32 and ``w2``,
and the P projected patches stand before the text, the positions running
over the whole ``[patches; text]`` sequence (``_embed_inputs``); the
loss scores text token i at position P + i - 1 (``lm_loss``).  Where the
reference scans over the stack, the port runs a Python loop over layer
slices, and ``remat`` wraps each block in ``torch.utils.checkpoint``
where the reference wraps it in ``jax.checkpoint``.  Caches are updated
in place (the reference donates them to its jitted steps instead); a
cache is a NamedTuple of tensors, or a dict: for the hybrid family
``{"ssm": SSMState [G, k, ...], "attn": KVCache [G, ...]}``, for the
encoder-decoder ``{"self": KVCache [L, ...], "cross_k", "cross_v": [L,
B, F, H, D]}``, and ``map_cache`` (``core.sharding``) walks either.

Under a plan, ``core.steps.build_train_step`` sets three attributes
(all None by default, so every one-device path is unchanged) and hands
the model this rank's blocks of the params:

  * ``model_axis`` (a ``core.sharding.ModelAxis``) under the plans that
    shard weights: the layers run tensor-parallel (attention and MLP,
    the experts, the SSM's channels), with the logits cut on the vocab
    when the table is, and ``lm_loss`` takes the vocab-parallel
    logsumexp;
  * ``fsdp`` (a ``core.sharding.FsdpGather``) under fsdp: every leaf cut
    over the data axes is gathered at its use, a layer's inside the
    layer loop;
  * ``dispatch`` (a ``moe.Dispatch``): which tokens the MoE layers route
    together.

Serving under a plan (``serve.steps.ServePlan``) sets ``model_axis``,
``fsdp`` and ``dispatch`` the same way for the length of each step;
``prefill`` and ``decode_step`` then take the ``blocks`` of the ring
this rank's cache holds (``attention.RingBlocks``) and return the whole
vocabulary's logits on every rank, and ``init_cache`` /
``init_slot_cache`` give a rank its rows, block and SSM channels.  A
pipeline stage serves through the pieces of those two (``decode_embed``,
``serve_layers`` over its layers' rows of the cache, ``serve_logits``).

``lm_loss``'s ``batch_group`` divides by the token count of the whole
batch across the ranks that split it, as the reference's SPMD loss does.
A pipeline stage runs the pieces: ``embed_stage``, ``run_layers`` over
its chunk of the stack (a hybrid chunk with the shared block), and
``head_loss`` with an outside denominator.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import (
    FsdpGather, ModelAxis, all_gather, all_reduce, copy_to_model, map_cache,
    reduce_from_model,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import Dispatch
from repro_torch.models.layers import (
    apply_norm, dense_init, embed, init_embedding, init_learned_positions,
    init_norm, lookup_rows, unembed,
)

Params = Dict[str, Any]
Cache = Union[attn_mod.KVCache, attn_mod.QuantKVCache, attn_mod.MLACache,
              ssm_mod.SSMState, Dict[str, Any]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# family -> (init, forward, prefill, decode) of its stacked layer block;
# the hybrid family's groups also run the dense block as their shared one
_FORWARD, _PREFILL, _DECODE = 1, 2, 3
_BLOCKS = {
    "dense": (blocks.init_dense_block, blocks.dense_block_forward,
              blocks.dense_block_prefill, blocks.dense_block_decode),
    "vlm": (blocks.init_dense_block, blocks.dense_block_forward,
            blocks.dense_block_prefill, blocks.dense_block_decode),
    "moe": (blocks.init_moe_block, blocks.moe_block_forward,
            blocks.moe_block_prefill, blocks.moe_block_decode),
    "ssm": (blocks.init_ssm_block, blocks.ssm_block_forward,
            blocks.ssm_block_prefill, blocks.ssm_block_decode),
    "hybrid": (blocks.init_mamba2_block, blocks.mamba2_block_forward,
               blocks.mamba2_block_prefill, blocks.mamba2_block_decode),
    "encdec": (blocks.init_encdec_block, blocks.encdec_block_forward,
               blocks.encdec_block_prefill, blocks.encdec_block_decode),
}


def trains_through_kernels(cfg: ModelConfig) -> bool:
    """Whether every kernel a training step of ``cfg`` reaches has a
    backward on the card.  Only kernel A has one, at head dims 64 and 80
    (not MLA's split ones), so only the dense family with LayerNorm
    (GPT-2) and the encoder-decoder (whisper, heads of 64) train through
    the kernels; the launchers train the others (the VLM's heads of 96
    too) with
    ``use_kernels=False`` (their kernels' wrappers raise when a gradient
    is taken; ROADMAP queue 2, item 7)."""
    return cfg.family in ("dense", "encdec") and cfg.norm == "layernorm" \
        and cfg.mla is None


def unstack(tree) -> List:
    """The per-layer trees of a stacked parameter dict: every leaf unbound
    on its leading axis (views, no copies).  One ``unbind`` per leaf, so
    the gradients of all layers land in the stacked leaf in one stack;
    indexing layer by layer would add a full-size zero gradient per
    layer."""
    if isinstance(tree, dict):
        per_key = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def _cache_layer(cache, i: int):
    """Layer ``i`` of a stacked cache (views, no copies)."""
    return map_cache(lambda _, leaf: leaf[i], cache)


def _restack(cache, layer_caches):
    """The stacked cache after a pass over its layers.  k/v and recurrent
    states were written in place; only the per-layer ring indices of an
    attention cache are new tensors."""
    if isinstance(cache, dict):
        return {k: _restack(v, [c[k] for c in layer_caches])
                for k, v in cache.items()}
    if not isinstance(cache, tuple) or "index" not in cache._fields:
        return cache
    return cache._replace(
        index=torch.stack([c.index for c in layer_caches]))


class Model:
    """Functional model around a ModelConfig: the dense (GPT-2, llama,
    phi4-mini, MiniCPM3), ``moe`` (phi3.5-MoE, DeepSeek-V2), ``ssm``
    (falcon-mamba), ``hybrid`` (zamba2), ``encdec`` (whisper) and ``vlm``
    (phi-3-vision) families, with Multi-head Latent Attention where the
    config has an ``MLAConfig``.

    ``device`` defaults to "cuda" and raises when no card is present.
    ``use_kernels=False`` runs the kernels' plain PyTorch versions (the
    reference's jnp algorithms for the scans) on the card too: the
    reference's ``use_pallas`` flag, inverted in default, since the
    port's main path is the kernel path."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 use_kernels: bool = True):
        if cfg.family not in _BLOCKS:
            raise NotImplementedError(
                f"family {cfg.family!r} is not one of the reference's "
                f"families; the port serves {sorted(_BLOCKS)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.compute_dtype = _DTYPES[cfg.dtype]
        self.model_axis: Optional[ModelAxis] = None
        self.fsdp: Optional[FsdpGather] = None
        self.dispatch: Optional[Dispatch] = None

    @property
    def _groups(self) -> Tuple[int, int]:
        """(G, k) of the hybrid family: G groups of k Mamba2 layers."""
        k = self.cfg.hybrid_attn_every
        return self.cfg.n_layers // k, k

    # ----------------------------------------------------------------- #
    def init(self, generator: torch.Generator, *, device=None) -> Params:
        """Fresh fp32 params with the reference's shapes and init laws, on
        ``device`` (default the model's; "meta" gives the shapes without
        storage).  ``generator`` must live on that device type (any for
        "meta")."""
        cfg = self.cfg
        dev = self.device if device is None else torch.device(device)
        init_block = _BLOCKS[cfg.family][0]
        params: Params = {
            "embed": init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                    device=dev),
            "final_norm": init_norm(cfg.d_model, cfg.norm, device=dev),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = init_embedding(generator, cfg.vocab_size,
                                               cfg.d_model, device=dev)
        if not cfg.rope_theta and cfg.family != "ssm":
            params["pos_embed"] = init_learned_positions(
                generator, cfg.max_seq_len, cfg.d_model, device=dev)
        if cfg.family == "hybrid":
            G, k = self._groups
            params["layers"] = {                     # [G, k, ...] + [G]
                "blocks": init_block(generator, cfg, lead=(G, k),
                                     device=dev),
                "gates": torch.ones((G,), device=dev),
            }
            params["shared"] = blocks.init_dense_block(generator, cfg,
                                                       device=dev)
        else:
            params["layers"] = init_block(generator, cfg,
                                          lead=(cfg.n_layers,), device=dev)
        if cfg.family == "encdec":
            params["encoder"] = {
                "layers": blocks.init_encoder_block(
                    generator, cfg, lead=(cfg.n_enc_layers,), device=dev),
                "norm": init_norm(cfg.d_model, cfg.norm, device=dev),
                "pos": init_learned_positions(generator, cfg.enc_seq_len,
                                              cfg.d_model, device=dev),
            }
        if cfg.family == "vlm":
            params["projector"] = {
                "w1": dense_init(generator, (cfg.vision_dim, cfg.d_model),
                                 cfg.vision_dim, device=dev),
                "w2": dense_init(generator, (cfg.d_model, cfg.d_model),
                                 cfg.d_model, device=dev),
            }
        return params

    # ----------------------------------------------------------------- #
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _use(self, path: str, tree, depth: int = 0,
             upto: Optional[int] = None):
        """The params node at ``path`` as its use needs it: under fsdp
        its leaves cut over the data axes gathered (``FsdpGather``),
        else as it is."""
        if self.fsdp is None:
            return tree
        return self.fsdp(path, tree, depth, upto)

    def _embed_inputs(self, params, batch, model_axis=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (x, positions); positions stay None when the batch
        gives none (arange, the serving case the flash kernel takes).
        For the vision-language family x is ``[patches; text]``
        (``_patches``), and given positions cover both."""
        dt = self.compute_dtype
        tokens = self._tokens(batch["tokens"])
        x = embed(tokens, self._use("embed", params["embed"]), dt,
                  model_axis)
        if self.cfg.family == "vlm":
            x = torch.cat([self._patches(params, batch), x], dim=1)
        positions = batch.get("positions")
        if positions is not None:
            positions = torch.as_tensor(positions, device=self.device)
        if "pos_embed" in params:
            table = self._use("pos_embed", params["pos_embed"])["table"]
            if model_axis is not None and model_axis.positions:
                ids = positions.long() if positions is not None else \
                    torch.arange(x.shape[1], device=x.device)[None]
                pe = lookup_rows(ids, table, model_axis)
            else:
                pe = table[positions.long()] if positions is not None \
                    else table[: x.shape[1]][None]
            x = x + pe.to(dt)
        return x, positions

    def _patches(self, params, batch) -> torch.Tensor:
        """The vision-language family's prefix [B, P, d] in the compute
        dtype: the batch's ``patch_embeds`` [B, P, vision_dim] through
        the projector, ``w1``, the tanh GELU in fp32 (``jax.nn.gelu``'s
        default), ``w2``.  Whole on every rank under a plan (its specs
        cut it over no model axis); under fsdp gathered at its use."""
        dt = self.compute_dtype
        proj = self._use("projector", params["projector"])
        p = torch.as_tensor(batch["patch_embeds"], device=self.device).to(dt)
        p = torch.einsum("bpv,vd->bpd", p, proj["w1"].to(dt))
        p = torch.nn.functional.gelu(p.float(), approximate="tanh").to(dt)
        return torch.einsum("bpd,de->bpe", p, proj["w2"].to(dt))

    def _head(self, params, x, model_axis=None) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, self._use("final_norm", params["final_norm"]),
                       cfg.norm, cfg.norm_eps, use_kernels=self.use_kernels)
        key = "embed" if cfg.tie_embeddings else "lm_head"
        return unembed(x, self._use(key, params[key]), self.compute_dtype,
                       model_axis)

    def _encode(self, params, batch) -> torch.Tensor:
        """Whisper's encoder over the batch's precomputed frame
        embeddings ``frames`` [B, F, d] (a stub frontend): the learned
        positions, the encoder layers (bidirectional attention through
        kernel A), the final norm.  [B, F, d] in the compute dtype.
        ``params`` needs ``encoder`` only.  Under a plan the layers run
        tensor-parallel over ``model_axis`` as the decoder's do, and
        under fsdp each leaf cut over the data axes is gathered at its
        use, a layer's inside the loop (the position table is cut over
        no model axis: the copied axis map has no ``embed_d``)."""
        cfg, dt = self.cfg, self.compute_dtype
        enc = params["encoder"]
        x = torch.as_tensor(batch["frames"], device=self.device).to(dt)
        table = self._use("encoder/pos", enc["pos"])["table"]
        x = x + table[: x.shape[1]].to(dt)
        path = "encoder/layers"
        for p in unstack(self._use(path, enc["layers"], 0, 1)):
            x = blocks.encoder_block_forward(x, self._use(path, p, 1), cfg,
                                             use_kernels=self.use_kernels,
                                             model_axis=self.model_axis)
        return apply_norm(x, self._use("encoder/norm", enc["norm"]),
                          cfg.norm, cfg.norm_eps,
                          use_kernels=self.use_kernels)

    def encoder_output(self, params, batch) -> torch.Tensor:
        """``_encode``'s output as the decoder layers read it: where the
        plan cuts the heads, through one f (``copy_to_model``), so that
        its gradient, partial over the heads, is summed over every layer
        first, in the order one device sums it, then over the model axis
        once (a pipeline's chunks pass the partial sum back to the
        first stage's f)."""
        enc = self._encode(params, batch)
        axis = self.model_axis
        if axis is not None and axis.heads:
            enc = copy_to_model(enc, axis)
        return enc

    def _encoder_kw(self, params, batch) -> Dict[str, Any]:
        """The block functions' ``enc_out`` of the encoder-decoder family:
        the encoder's output of ``batch`` (``encoder_output``), computed
        here once for every decoder layer, so a layer's recompute under
        remat reads it and does not rerun the encoder; none for the other
        families."""
        if self.cfg.family != "encdec":
            return {}
        return {"enc_out": self.encoder_output(params, batch)}

    def _run(self, params, x, cache, step: int, kw, remat: bool = False):
        """One pass over the layers with the family's block function
        ``_BLOCKS[family][step]`` (``_FORWARD``, ``_PREFILL`` or
        ``_DECODE``); a hybrid group first applies the shared dense block
        and its gate, ``h + gate * (y - h)``.  ``remat`` recomputes each
        block's activations in the backward instead of keeping them.
        Returns (x, cache, aux): aux holds each MoE block's load-balance
        loss over a forward pass, [n] (empty for the other families).

        Under fsdp (``self.fsdp``) each layer's leaves are gathered
        inside the block function, so a rank holds one layer whole at a
        time and remat's recompute gathers again; leaves cut on a stack
        dim are gathered before the loop."""
        cfg = self.cfg
        hybrid = cfg.family == "hybrid"
        path, depth = ("layers/blocks", 2) if hybrid else ("layers", 1)
        block = _BLOCKS[cfg.family][step]
        with_aux = cfg.family == "moe" and step == _FORWARD
        auxs = []
        dense = _BLOCKS["dense"][step]

        def fn(x, p, *a, **k):
            return block(x, self._use(path, p, depth), *a, **k)

        def shared_fn(x, p, *a, **k):
            return dense(x, self._use("shared", p), *a, **k)

        if remat:
            fn = partial(checkpoint, fn, use_reentrant=False)
            shared_fn = partial(checkpoint, shared_fn, use_reentrant=False)

        def run_stack(x, stack, cache):
            new = []
            for i, p in enumerate(unstack(stack)):
                if with_aux:
                    x, aux = fn(x, p, cfg, **kw)
                    auxs.append(aux)
                elif cache is None:
                    x = fn(x, p, cfg, **kw)
                else:
                    x, c = fn(x, p, cfg, cache=_cache_layer(cache, i), **kw)
                    new.append(c)
            return x, (None if cache is None else _restack(cache, new))

        if not hybrid:
            x, cache = run_stack(x, self._use(path, params["layers"], 0,
                                              depth), cache)
            aux = torch.stack(auxs) if auxs \
                else torch.zeros(0, device=x.device)
            return x, cache, aux
        stacked = self._use("layers", params["layers"], 0, depth)
        gates = stacked["gates"].unbind(0)
        attn_new = []
        for g, group in enumerate(unstack(stacked["blocks"])):
            if cache is None:
                y = shared_fn(x, params["shared"], cfg, **kw)
            else:
                y, c = shared_fn(x, params["shared"], cfg,
                                 cache=_cache_layer(cache["attn"], g), **kw)
                attn_new.append(c)
            x = x + gates[g].to(x.dtype) * (y - x)
            x, _ = run_stack(x, group, None if cache is None
                             else _cache_layer(cache["ssm"], g))
        aux = torch.zeros(0, device=x.device)
        if cache is None:
            return x, None, aux
        return x, {"ssm": cache["ssm"],
                   "attn": _restack(cache["attn"], attn_new)}, aux

    # ----------------------------------------------------------------- #
    def _forward(self, params, batch, *, window: int = 0,
                 remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits [B, S, V] fp32, aux loss): the reference's
        ``forward``, tensor-parallel under ``model_axis``."""
        axis = self.model_axis
        x, positions = self._embed_inputs(params, batch, axis)
        kw = self._plan_kw(positions, window)
        kw.update(self._encoder_kw(params, batch))
        x, _, aux = self._run(params, x, None, _FORWARD, kw, remat=remat)
        return self._head(params, x, axis), aux.sum()

    def _plan_kw(self, positions, window: int) -> Dict[str, Any]:
        """The block functions' keywords of a training forward: the
        plan's model axis and the MoE dispatch where there are."""
        kw = dict(positions=positions, window=window,
                  use_kernels=self.use_kernels)
        if self.model_axis is not None:
            kw["model_axis"] = self.model_axis
        if self.dispatch is not None:
            kw["dispatch"] = self.dispatch
        return kw

    def forward(self, params, batch, *, window: int = 0,
                remat: bool = False) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (fp32; this rank's vocab columns
        when ``model_axis`` cuts the table)."""
        return self._forward(params, batch, window=window, remat=remat)[0]

    def hidden(self, params, batch) -> torch.Tensor:
        """Final hidden states [B, S, d] before the final norm (the
        reference's ``run_stack`` output)."""
        x, positions = self._embed_inputs(params, batch)
        x, _, _ = self._run(params, x, None, _FORWARD, dict(
            positions=positions, window=0, use_kernels=self.use_kernels,
            **self._encoder_kw(params, batch)))
        return x

    # the pieces a pipeline stage runs (``core.pipeline.StageRunner``)
    def embed_stage(self, params, batch
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The first stage's embedding: ``(x, positions)`` of ``batch``
        under ``model_axis``; ``params`` needs ``embed`` (and
        ``pos_embed``, the ``projector``) only."""
        return self._embed_inputs(params, batch, self.model_axis)

    def run_layers(self, layers, x, *, positions=None, remat: bool = False,
                   shared=None, enc_out=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)`` after the layers of a sub-stack ``layers``
        (leaves ``[n, ...]``; the hybrid family's groups, with the
        ``shared`` block at the head of each; an encoder-decoder's over
        the encoder's output ``enc_out``), as ``_run`` runs the whole
        stack; aux holds the MoE family's aux of each layer, [n]."""
        params = {"layers": layers}
        if shared is not None:
            params["shared"] = shared
        kw = self._plan_kw(positions, 0)
        if enc_out is not None:
            kw["enc_out"] = enc_out
        x, _, aux = self._run(params, x, None, _FORWARD, kw, remat=remat)
        return x, aux

    def head_loss(self, params, x, batch, *, denom
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The last stage's final norm, head and ``lm_loss`` of the
        hidden states ``x`` of ``batch``, divided by ``denom`` (the whole
        batch's token count when ``batch`` is one microbatch of it);
        ``params`` needs ``final_norm`` and the head's table only."""
        logits = self._head(params, x, self.model_axis)
        return lm_loss(self.cfg, logits, batch,
                       torch.zeros((), device=x.device),
                       model_axis=self.model_axis, denom=denom)

    def loss(self, params, batch, *, remat: bool = True, batch_group=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, metrics) of a batch with ``tokens`` and ``labels``: the
        reference's ``Model.loss``, with the MoE family's load-balance
        loss summed over the layers (0 for the other families).
        ``batch_group``: see ``lm_loss``."""
        logits, aux = self._forward(params, batch, remat=remat)
        return lm_loss(self.cfg, logits, batch, aux,
                       model_axis=self.model_axis, batch_group=batch_group)

    # ----------------------------------------------------------------- #
    def init_cache(self, batch: int, capacity: int, *, window: int = 0,
                   kv_dtype: str = "fp32", rows: Optional[int] = None,
                   seq_blocks: int = 1, channel_blocks: int = 1,
                   frame_blocks: int = 1, depth: Optional[int] = None,
                   device=None) -> Cache:
        """Decode cache, leaves stacked on the layer axis (``[G, ...]``
        and ``[G, k, ...]`` for the hybrid family; the latent
        ``MLACache`` for an MLA config; for the encoder-decoder the
        self-attention's ``KVCache`` beside ``cross_k`` and ``cross_v``
        [L, B, F, H, D] in the compute dtype, filled at prefill).
        ``kv_dtype='fp32'`` keeps k/v
        in the compute dtype (the reference's name); 'int8' is the
        quantized cache decode runs through kernel B, for the dense,
        vision-language and MoE families without MLA only, as in the
        reference.  A vision-language model's prefill fills its P patches
        and the prompt, so ``capacity`` covers P + prompt + new tokens.

        Under a serving plan a rank holds ``rows`` of the ``batch`` rows,
        one of ``seq_blocks`` blocks of the ring's slots, its part of the
        SSM states of layers whose ``d_inner`` is cut into
        ``channel_blocks`` (``ssm.init_ssm_state``), one of
        ``frame_blocks`` blocks of the cross cache's frames (every head's)
        and, under a pipeline, the ``depth`` entries of the stack (layers,
        or the hybrid family's groups) of its stage
        (``serve.steps.ServePlan``).
        ``device`` (default the model's): "meta" gives the shapes
        alone."""
        cfg, dt = self.cfg, self.compute_dtype
        dev = self.device if device is None else torch.device(device)
        cap = min(capacity, window) if window else capacity
        if cap % seq_blocks:
            raise ValueError(f"a ring of {cap} slots does not cut into "
                             f"{seq_blocks} blocks")
        cap //= seq_blocks
        batch = batch if rows is None else rows
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected "
                             f"'fp32' or 'int8'")
        if kv_dtype == "int8" and (cfg.family not in ("dense", "vlm", "moe")
                                   or cfg.mla is not None):
            raise ValueError(
                "kv_dtype='int8' needs a plain-GQA attention cache; "
                f"family {cfg.family!r}"
                + (" with MLA" if cfg.mla is not None else "")
                + " stores no quantizable k/v tensors")
        ssm_kw = dict(device=dev, channel_blocks=channel_blocks)
        if cfg.family == "ssm":
            return ssm_mod.init_ssm_state(cfg, batch, dt,
                                          lead=(depth or cfg.n_layers,),
                                          **ssm_kw)
        if cfg.family == "encdec":
            if cfg.enc_seq_len % frame_blocks:
                raise ValueError(f"{cfg.enc_seq_len} frames do not cut into "
                                 f"{frame_blocks} blocks")
            shape = (depth or cfg.n_layers, batch,
                     cfg.enc_seq_len // frame_blocks, cfg.n_heads,
                     cfg.head_dim)
            return {
                "self": attn_mod.init_kv_cache(
                    batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                    dt, lead=shape[:1], device=dev),
                "cross_k": torch.zeros(shape, dtype=dt, device=dev),
                "cross_v": torch.zeros(shape, dtype=dt, device=dev),
            }
        if cfg.family == "hybrid":
            G, k = self._groups
            G = depth or G
            return {
                "ssm": ssm_mod.init_ssm_state(cfg, batch, dt, lead=(G, k),
                                              **ssm_kw),
                "attn": attn_mod.init_kv_cache(
                    batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                    dt, lead=(G,), device=dev),
            }
        lead = (depth or cfg.n_layers,)
        if cfg.mla is not None:
            return attn_mod.init_mla_cache(batch, cap, cfg.mla, dt,
                                           lead=lead, device=dev)
        if kv_dtype == "int8":
            return attn_mod.init_quant_kv_cache(
                batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                lead=lead, device=dev)
        return attn_mod.init_kv_cache(
            batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim, dt,
            lead=lead, device=dev)

    def init_slot_cache(self, batch: int, capacity: int, *, window: int = 0,
                        kv_dtype: str = "fp32", **kw) -> Cache:
        """Per-slot cache for continuous batching: ``init_cache`` with
        every ring ``index`` widened by a trailing ``[batch]`` axis, one
        fill position per slot.  SSM state carries no index.  Under a
        serving plan (``init_cache``'s keywords) every rank holds the
        whole index, every slot's."""
        cache = self.init_cache(batch, capacity, window=window,
                                kv_dtype=kv_dtype, **kw)
        return map_cache(
            lambda name, leaf: torch.zeros(
                leaf.shape + (batch,), dtype=leaf.dtype, device=leaf.device)
            if name == "index" else leaf, cache)

    # ----------------------------------------------------------------- #
    def prefill(self, params, batch, cache: Cache, *, window: int = 0,
                last_pos=None, blocks=None) -> Tuple[torch.Tensor, Cache]:
        """Returns (logits [B, V] at the last position, or at ``last_pos``
        for a bucket-padded prompt; filled cache).  The recurrent layers
        start from the cache's state ``h``, as the reference's do.
        ``blocks``: the ring's blocks under a serving plan."""
        x, positions = self._embed_inputs(params, batch, self.model_axis)
        x, cache = self.serve_layers(params, x, cache, window=window,
                                     positions=positions, blocks=blocks,
                                     **self._encoder_kw(params, batch))
        return self.serve_logits(params, x, last_pos), cache

    def decode_step(self, params, cache: Cache, tokens, *, window: int = 0,
                    blocks=None) -> Tuple[torch.Tensor, Cache]:
        """tokens: [B, 1] -> (logits [B, V], cache advanced one token).
        ``blocks``: the ring's blocks under a serving plan."""
        x = self.decode_embed(params, cache, tokens)
        x, cache = self.serve_layers(params, x, cache, decode=True,
                                     window=window, blocks=blocks)
        return self.serve_logits(params, x), cache

    # the pieces of prefill and decode a pipeline stage runs
    # (``core.pipeline.StageServer``)
    def decode_embed(self, params, cache: Cache, tokens) -> torch.Tensor:
        """The hidden states [B, 1, d] of the decode ``tokens`` [B, 1] at
        the cache's position; ``params`` needs ``embed`` (and
        ``pos_embed``) only."""
        cfg, dt, axis = self.cfg, self.compute_dtype, self.model_axis
        x = embed(self._tokens(tokens), self._use("embed", params["embed"]),
                  dt, axis)
        if "pos_embed" in params:
            pos = torch.clamp(self._cache_index(cache), 0,
                              cfg.max_seq_len - 1).long()
            ids = pos[None, None] if pos.dim() == 0 else pos[:, None]
            table = self._use("pos_embed", params["pos_embed"])["table"]
            pe = lookup_rows(ids, table, axis) \
                if axis is not None and axis.positions else table[ids]
            x = x + pe.to(dt)
        return x

    def serve_layers(self, params, x, cache: Cache, *, decode: bool = False,
                     window: int = 0, positions=None, blocks=None,
                     enc_out=None) -> Tuple[torch.Tensor, Cache]:
        """``(x, cache)`` after the prefill (or one ``decode`` step) of
        the layers of ``params["layers"]`` (a sub-stack, with the hybrid
        family's ``shared`` block) on ``cache``, whose stack holds the
        same layers.  ``enc_out``: the encoder's output an
        encoder-decoder's prefill attends over (its decode reads the
        cache's)."""
        kw = self._serve_kw(blocks, window=window)
        if not decode:
            kw["positions"] = positions
        if enc_out is not None:
            kw["enc_out"] = enc_out
        x, cache, _ = self._run(params, x, cache,
                                _DECODE if decode else _PREFILL, kw)
        return x, cache

    def serve_logits(self, params, x, last_pos=None) -> torch.Tensor:
        """The logits [B, V] of the hidden states ``x`` [B, S, d] at
        ``last_pos`` (default the last position); ``params`` needs
        ``final_norm`` and the head's table only."""
        if last_pos is None:
            last_pos = x.shape[1] - 1
        return self._logits(params, x[:, last_pos:last_pos + 1])

    def _serve_kw(self, blocks, **kw) -> Dict[str, Any]:
        """The block functions' keywords of prefill and decode: the
        plan's model axis, the MoE dispatch and the ring's blocks where
        there are."""
        kw["use_kernels"] = self.use_kernels
        if self.model_axis is not None:
            kw["model_axis"] = self.model_axis
        if self.dispatch is not None:
            kw["dispatch"] = self.dispatch
        if blocks is not None:
            kw["blocks"] = blocks
        return kw

    def _logits(self, params, x) -> torch.Tensor:
        """The logits [B, V] of one position's hidden states [B, 1, d]:
        the whole vocabulary on every rank (the ranks' blocks gathered in
        rank order where the plan cuts the table)."""
        axis = self.model_axis
        logits = self._head(params, x, axis)[:, 0]
        if axis is not None and axis.vocab:
            logits = all_gather(logits, axis.group, -1)
        return logits

    def _cache_index(self, cache: Cache) -> torch.Tensor:
        """Current absolute position: the first ring index leaf's layer 0
        (scalar, or [B] for a per-slot cache); 0 for a cache without one
        (pure SSM state)."""
        found = []
        map_cache(lambda name, leaf: found.append(leaf)
                  if name == "index" else None, cache)
        if not found:
            return torch.zeros((), dtype=torch.int32, device=self.device)
        return found[0][0]


class _VocabLogsumexp(torch.autograd.Function):
    """logsumexp over the last dim of logits cut over the ``model`` axis:
    ``torch.logsumexp``'s own operations on each rank's block (the max,
    exp of the difference, the sum, its log plus the max), with the max
    and the sum taken over the axis; backward ``g * exp(logits - lse)``,
    its formula.  On an axis of one rank it gives ``torch.logsumexp``'s
    numbers."""

    @staticmethod
    def forward(ctx, logits, group):
        gmax = all_reduce(logits.amax(-1), group, "max")
        sumexp = all_reduce((logits - gmax[..., None]).exp_().sum(-1), group)
        lse = sumexp.log_().add_(gmax)
        ctx.save_for_backward(logits, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        logits, lse = ctx.saved_tensors
        return g[..., None] * (logits - lse[..., None]).exp(), None


def _vocab_parallel(logits32, labels_safe, axis: ModelAxis):
    """(lse, label logit, argmax) of logits cut on the vocab over the
    ``model`` axis, this rank holding columns ``[rank * V_l, (rank + 1) *
    V_l)``: the logsumexp over the axis (``_VocabLogsumexp``), the
    label's logit from its owner, and the argmax with ``torch.argmax``'s
    first-index rule across the ranks."""
    V_l = logits32.shape[-1]
    start = axis.rank * V_l
    lse = _VocabLogsumexp.apply(logits32, axis.group)
    local = labels_safe - start
    held = (local >= 0) & (local < V_l)
    picked = torch.gather(logits32, -1, torch.where(held, local, 0)[..., None])
    label_logit = reduce_from_model(
        torch.where(held, picked[..., 0], 0.0), axis)
    local_max, local_arg = logits32.detach().max(dim=-1)
    gmax = all_reduce(local_max.clone(), axis.group, "max")
    arg = torch.where(local_max == gmax, local_arg + start,
                      torch.full_like(local_arg, axis.size * V_l))
    return lse, label_logit, all_reduce(arg, axis.group, "min")


def n_prefix(cfg: ModelConfig, batch) -> int:
    """Positions before the text: the vision-language family's P patches
    (``batch["patch_embeds"]`` [B, P, vision_dim]), 0 for the others."""
    if cfg.family != "vlm":
        return 0
    return batch["patch_embeds"].shape[1]


def scored_labels(cfg: ModelConfig, labels):
    """The labels ``lm_loss`` scores: shifted one on, as the reference's
    causal LM; whole for the vision-language family, whose text token i
    is predicted at position P + i - 1 of the ``[patches; text]``
    sequence."""
    return labels if cfg.family == "vlm" else labels[:, 1:]


def lm_loss(cfg: ModelConfig, logits, batch, aux, *,
            model_axis: Optional[ModelAxis] = None, batch_group=None,
            denom: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM objective (port of ``repro/models/model.py:lm_loss``):
    cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]`` (for
    the vision-language family, of the logits from position P - 1 on
    against every text label: ``scored_labels``), plus a 1e-4 z-loss on
    the logsumexp, plus ``aux``; labels below 0 are masked, and the
    denominator counts the scored labels.  The label's logit is a
    gather where the reference contracts a one-hot, which keeps a
    vocab-sharded axis partitioned; on one device only the value
    matters, and the one-hot would be an fp32 [B, S, V] tensor (1.65 GB
    for gpt2m at batch 8, seq 1024).

    ``model_axis`` with ``vocab``: the logits are this rank's vocab
    columns (``_vocab_parallel``).  ``batch_group``: the ranks that split
    the batch; the denominator is their tokens together, so their losses
    and gradients add up to the loss and gradients of the whole batch.
    ``denom``: that count given from outside (a pipeline's microbatch
    divides by the whole batch's), in place of this batch's own.

    The shift is the reference's, and the Loader's labels are already
    the next token, so on Loader batches position i is scored against
    token i + 2, as in the reference (ROADMAP queue 3)."""
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = logits[:, n_prefix(cfg, batch) - 1:-1] if cfg.family == "vlm" \
        else logits[:, :-1]
    labels = scored_labels(cfg, labels)
    mask = labels >= 0
    labels_safe = torch.where(mask, labels, 0)
    logits32 = logits.float()
    if model_axis is not None and model_axis.vocab:
        lse, label_logit, pred = _vocab_parallel(logits32, labels_safe,
                                                 model_axis)
    else:
        lse = torch.logsumexp(logits32, dim=-1)
        label_logit = torch.gather(logits32, -1,
                                   labels_safe[..., None])[..., 0]
        pred = torch.argmax(logits, -1)
    nll = lse - label_logit
    if denom is None:
        count = mask.sum()
        if batch_group is not None:
            count = all_reduce(count, batch_group)
        denom = torch.clamp(count, min=1)
    ce = torch.where(mask, nll, 0.0).sum() / denom
    # z-loss keeps the softmax normalizer in check (PaLM-style)
    zl = torch.where(mask, lse.square(), 0.0).sum() / denom
    loss = ce + 1e-4 * zl + aux
    acc = (mask & (pred == labels_safe)).sum() / denom
    return loss, {"ce": ce, "aux": aux, "zloss": zl, "accuracy": acc,
                  "tokens": denom.float()}
