"""Model assembly for the dense, MoE, SSM and hybrid families (port of
``repro/models/model.py``): embeddings -> stacked layers -> head, with
forward, loss, prefill and decode.  The MoE family's per-layer
load-balance losses are summed over the stack into ``Model.loss``, as
the reference's ``run_stack`` sums them; serving ignores them.

Layer parameters and caches keep the reference's stacked layout:
``[L, ...]``, and for the hybrid family ``layers/blocks`` as ``[G, k,
...]`` (G groups of k Mamba2 layers), ``layers/gates`` as ``[G]`` and one
``shared`` dense block applied at the head of every group.  Where the
reference scans over the stack, the port runs a Python loop over layer
slices, and ``remat`` wraps each block in ``torch.utils.checkpoint``
where the reference wraps it in ``jax.checkpoint``.  Caches are updated
in place (the reference donates them to its jitted steps instead); a
cache is a NamedTuple of tensors, or for the hybrid family a dict
``{"ssm": SSMState [G, k, ...], "attn": KVCache [G, ...]}``, and
``map_cache`` walks either.

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

``lm_loss``'s ``batch_group`` divides by the token count of the whole
batch across the ranks that split it, as the reference's SPMD loss does.
A pipeline stage runs the pieces: ``embed_stage``, ``run_layers`` over
its chunk of the stack (a hybrid chunk with the shared block), and
``head_loss`` with an outside denominator.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import (
    FsdpGather, ModelAxis, all_reduce, reduce_from_model,
)
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import Dispatch
from repro_torch.models.layers import (
    apply_norm, embed, init_embedding, init_learned_positions, init_norm,
    lookup_rows, unembed,
)

Params = Dict[str, Any]
Cache = Union[attn_mod.KVCache, attn_mod.QuantKVCache, ssm_mod.SSMState,
              Dict[str, Any]]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# family -> (init, forward, prefill, decode) of its stacked layer block;
# the hybrid family's groups also run the dense block as their shared one
_FORWARD, _PREFILL, _DECODE = 1, 2, 3
_BLOCKS = {
    "dense": (blocks.init_dense_block, blocks.dense_block_forward,
              blocks.dense_block_prefill, blocks.dense_block_decode),
    "moe": (blocks.init_moe_block, blocks.moe_block_forward,
            blocks.moe_block_prefill, blocks.moe_block_decode),
    "ssm": (blocks.init_ssm_block, blocks.ssm_block_forward,
            blocks.ssm_block_prefill, blocks.ssm_block_decode),
    "hybrid": (blocks.init_mamba2_block, blocks.mamba2_block_forward,
               blocks.mamba2_block_prefill, blocks.mamba2_block_decode),
}


def trains_through_kernels(cfg: ModelConfig) -> bool:
    """Whether every kernel a training step of ``cfg`` reaches has a
    backward on the card.  Only kernel A has one, so only the dense
    family with LayerNorm (GPT-2) trains through the kernels; the
    launchers train the others with ``use_kernels=False`` (their kernels'
    wrappers raise when a gradient is taken; ROADMAP queue 2, item 7)."""
    return cfg.family == "dense" and cfg.norm == "layernorm"


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


def map_cache(fn: Callable, *caches, name: str = ""):
    """``fn(leaf_name, *leaves)`` over caches of one structure (NamedTuples
    and dicts of tensors); returns the same structure of its results."""
    c0 = caches[0]
    if isinstance(c0, dict):
        return {k: map_cache(fn, *(c[k] for c in caches), name=k)
                for k in c0}
    if isinstance(c0, tuple):
        return type(c0)(*(map_cache(fn, *(getattr(c, f) for c in caches),
                                    name=f) for f in c0._fields))
    return fn(name, *caches)


def _cache_layer(cache, i: int):
    """Layer ``i`` of a stacked cache NamedTuple (views, no copies)."""
    return type(cache)(*(leaf[i] for leaf in cache))


def _restack(cache, layer_caches):
    """The stacked cache after a pass over its layers.  k/v and recurrent
    states were written in place; only the per-layer ring indices of an
    attention cache are new tensors."""
    if "index" not in cache._fields:
        return cache
    return cache._replace(
        index=torch.stack([c.index for c in layer_caches]))


class Model:
    """Functional model around a ModelConfig: the dense (GPT-2, llama),
    ``moe`` (phi3.5-MoE), ``ssm`` (falcon-mamba) and ``hybrid`` (zamba2)
    families.

    ``device`` defaults to "cuda" and raises when no card is present.
    ``use_kernels=False`` runs the kernels' plain PyTorch versions (the
    reference's jnp algorithms for the scans) on the card too: the
    reference's ``use_pallas`` flag, inverted in default, since the
    port's main path is the kernel path."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 use_kernels: bool = True):
        if cfg.family not in _BLOCKS:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP queue "
                f"1, item 10); the port serves {sorted(_BLOCKS)}")
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
        gives none (arange, the serving case the flash kernel takes)."""
        dt = self.compute_dtype
        tokens = self._tokens(batch["tokens"])
        x = embed(tokens, self._use("embed", params["embed"]), dt,
                  model_axis)
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

    def _head(self, params, x, model_axis=None) -> torch.Tensor:
        cfg = self.cfg
        x = apply_norm(x, self._use("final_norm", params["final_norm"]),
                       cfg.norm, cfg.norm_eps, use_kernels=self.use_kernels)
        key = "embed" if cfg.tie_embeddings else "lm_head"
        return unembed(x, self._use(key, params[key]), self.compute_dtype,
                       model_axis)

    def _run(self, params, x, cache, step: int, kw, remat: bool = False):
        """One pass over the layers with the family's block function
        ``_BLOCKS[family][step]`` (``_FORWARD``, ``_PREFILL`` or
        ``_DECODE``); a hybrid group first applies the shared dense block
        and its gate, ``h + gate * (y - h)``.  ``remat`` recomputes each
        block's activations in the backward instead of keeping them.
        Returns (x, cache, aux): aux is the sum of the MoE blocks'
        load-balance losses over a forward pass, else 0.

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
            aux = torch.stack(auxs).sum() if auxs \
                else torch.zeros((), device=x.device)
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
        aux = torch.zeros((), device=x.device)
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
        x, _, aux = self._run(params, x, None, _FORWARD,
                              self._plan_kw(positions, window), remat=remat)
        return self._head(params, x, axis), aux

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
        x, _, _ = self._run(params, x, None, _FORWARD,
                            dict(positions=positions, window=0,
                                 use_kernels=self.use_kernels))
        return x

    # the pieces a pipeline stage runs (``core.pipeline.StageRunner``)
    def embed_stage(self, params, batch
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The first stage's embedding: ``(x, positions)`` of ``batch``
        under ``model_axis``; ``params`` needs ``embed`` (and
        ``pos_embed``) only."""
        return self._embed_inputs(params, batch, self.model_axis)

    def run_layers(self, layers, x, *, positions=None, remat: bool = False,
                   shared=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, aux)`` after the layers of a sub-stack ``layers``
        (leaves ``[n, ...]``; the hybrid family's groups, with the
        ``shared`` block at the head of each), as ``_run`` runs the whole
        stack."""
        params = {"layers": layers}
        if shared is not None:
            params["shared"] = shared
        x, _, aux = self._run(params, x, None, _FORWARD,
                              self._plan_kw(positions, 0), remat=remat)
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
                   kv_dtype: str = "fp32") -> Cache:
        """Decode cache, leaves stacked on the layer axis (``[G, ...]``
        and ``[G, k, ...]`` for the hybrid family).  ``kv_dtype='fp32'``
        keeps k/v in the compute dtype (the reference's name); 'int8' is
        the quantized cache decode runs through kernel B, for the dense
        and MoE families only, as in the reference."""
        cfg, dt, dev = self.cfg, self.compute_dtype, self.device
        cap = min(capacity, window) if window else capacity
        if kv_dtype not in ("fp32", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected "
                             f"'fp32' or 'int8'")
        if kv_dtype == "int8" and cfg.family not in ("dense", "moe"):
            raise ValueError(
                "kv_dtype='int8' needs a plain-GQA attention cache; "
                f"family {cfg.family!r} stores no quantizable k/v tensors")
        if cfg.family == "ssm":
            return ssm_mod.init_ssm_state(cfg, batch, dt,
                                          lead=(cfg.n_layers,), device=dev)
        if cfg.family == "hybrid":
            G, k = self._groups
            return {
                "ssm": ssm_mod.init_ssm_state(cfg, batch, dt, lead=(G, k),
                                              device=dev),
                "attn": attn_mod.init_kv_cache(
                    batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                    dt, lead=(G,), device=dev),
            }
        lead = (cfg.n_layers,)
        if kv_dtype == "int8":
            return attn_mod.init_quant_kv_cache(
                batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim,
                lead=lead, device=dev)
        return attn_mod.init_kv_cache(
            batch, cap, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim, dt,
            lead=lead, device=dev)

    def init_slot_cache(self, batch: int, capacity: int, *, window: int = 0,
                        kv_dtype: str = "fp32") -> Cache:
        """Per-slot cache for continuous batching: ``init_cache`` with
        every ring ``index`` widened by a trailing ``[batch]`` axis, one
        fill position per slot.  SSM state carries no index."""
        cache = self.init_cache(batch, capacity, window=window,
                                kv_dtype=kv_dtype)
        return map_cache(
            lambda name, leaf: torch.zeros(
                leaf.shape + (batch,), dtype=leaf.dtype, device=leaf.device)
            if name == "index" else leaf, cache)

    # ----------------------------------------------------------------- #
    def prefill(self, params, batch, cache: Cache, *, window: int = 0,
                last_pos=None) -> Tuple[torch.Tensor, Cache]:
        """Returns (logits [B, V] at the last position, or at ``last_pos``
        for a bucket-padded prompt; filled cache).  The recurrent layers
        start from the cache's state ``h``, as the reference's do."""
        x, positions = self._embed_inputs(params, batch)
        x, cache, _ = self._run(params, x, cache, _PREFILL,
                                dict(positions=positions, window=window,
                                     use_kernels=self.use_kernels))
        if last_pos is None:
            last_pos = x.shape[1] - 1
        x_last = x[:, last_pos:last_pos + 1]
        return self._head(params, x_last)[:, 0], cache

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
        x, cache, _ = self._run(params, x, cache, _DECODE,
                                dict(window=window,
                                     use_kernels=self.use_kernels))
        return self._head(params, x)[:, 0], cache

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


def lm_loss(cfg: ModelConfig, logits, batch, aux, *,
            model_axis: Optional[ModelAxis] = None, batch_group=None,
            denom: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM objective (port of ``repro/models/model.py:lm_loss``):
    cross-entropy of ``logits[:, :-1]`` against ``labels[:, 1:]``, plus a
    1e-4 z-loss on the logsumexp, plus ``aux``; labels below 0 are
    masked.  The label's logit is a gather where the reference contracts
    a one-hot, which keeps a vocab-sharded axis partitioned; on one
    device only the value matters, and the one-hot would be an fp32
    [B, S, V] tensor (1.65 GB for gpt2m at batch 8, seq 1024).

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
    logits = logits[:, :-1]
    labels = labels[:, 1:]
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
