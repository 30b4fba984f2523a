"""Serving steps: counterparts of the reference's ``build_prefill_step``,
``build_serve_step``, ``build_insert_step`` and
``build_decode_slots_step`` (``repro/core/steps.py``), on one device and
under every plan of ``core.plans.PLANS`` (``ServePlan``), for the dense,
vision-language, MoE, SSM, hybrid and encoder-decoder families, MLA's
latent cache included.  A
vision-language batch's ``patch_embeds`` are cut with its rows, and its
cache, whose ``max_len`` covers the patches too, takes ``cache_spec``'s
layout as any KV cache does; an encoder-decoder batch's ``frames`` are
cut with its rows, and its cross cache's frames over ``model`` as the
ring's slots are (``models.blocks.frame_blocks``).

PyTorch runs eagerly, so each step is a plain function rather than a
compiled one, and the caches the reference donates are updated in place
here.  A cache is any structure of NamedTuples and dicts of tensors (a
KV cache, an SSM state, the hybrid family's ``{"ssm", "attn"}`` dict);
the slot steps walk it with ``map_cache`` and treat the leaves named
``index`` (ring fill positions) apart.

Under a plan (``plan=ServePlan(...)``) every rank is given the whole
batch (tokens, ``live``) and returns the whole batch's logits and tokens,
the same on every rank, as the reference's steps return replicated
outputs.  A rank runs its rows of the batch (the plan's batch axes; a
batch they do not divide runs whole on every rank) through the model
under the plan's cut of the weights, on its rows and block of the cache
(``Plan.cache_spec``'s layout: under the plans that shard weights the
ring's slots are cut over ``model``, ``models.attention.RingBlocks``,
and an SSM state's channels with ``d_inner``).  The MoE family routes
as the reference's ``_set_moe_dispatch`` says: each batch rank's tokens
on their own under the flat plans, the whole batch as one under
pipeshard.  Under pipeshard a rank holds its stage's layers and their
rows of the cache, and the step runs through the stages
(``core.pipeline.StageServer``).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.pipeline import (
    StageServer, held_rows, stack_length, stage_rows, validate_stages,
)
from repro_torch.core.plans import MODEL_AXIS, STAGE_AXIS, Plan, get_plan
from repro_torch.core.sharding import (
    FsdpGather, Mesh, all_gather, shard_tree, slice_leaf, tree_map_with_path,
)
from repro_torch.core.steps import (
    _dispatch, _local_rows, _model_axis, stage_local_specs,
)
from repro_torch.models.attention import WHOLE_RING, RingBlocks
from repro_torch.models.model import Cache, Model, map_cache

# the SSM state's leaves (``models.ssm.SSMState``) and the
# encoder-decoder's cross cache
_SSM_LEAVES = ("conv", "h")
_CROSS_LEAVES = ("cross_k", "cross_v")


class ServePlan:
    """Serving under ``plan`` on ``mesh``: for the engines and the steps
    what ``core.steps.PlanStep`` and ``PipelineStep`` are for training.
    It holds the plan's specs of the params, the ``model`` axis of the
    weights' cut (``core.steps._model_axis``), fsdp's gather of the
    leaves cut over the data axes, under pipeshard the stage's layers
    and its ``StageServer``, and the layout of the caches:
    ``Plan.cache_spec``'s, with a rank's rows of a batch those of the
    plan's batch axes.

    The caches hold ``max_len`` positions (a ring of ``window`` when it
    is set); under the plans that shard weights, when ``model`` divides
    that capacity, a rank holds the block ``[r c, (r + 1) c)`` of every
    KV head's ring, or of an MLA model's latent and rope key
    (``blocks``), else the whole ring.  Where the layout
    a rank holds differs from ``cache_spec``'s, it changes memory, not
    numbers:

      * under data and zero2 ``cache_spec`` cuts the cache's batch dim
        over the data axes only, while their batch axes also take
        ``model``: a rank holds the rows of its part of the batch;
      * with ``d_inner`` cut over ``model`` a rank's SSM state holds the
        conv inputs its computation uses (Mamba1: its channels'; Mamba2:
        its x channels' and the whole B and C), where ``cache_spec``
        keeps the conv state whole;
      * under pipeshard a rank holds its stage's layers' rows of the
        cache, where ``cache_spec`` keeps the layer dim whole over
        ``stage``;
      * at a batch as large as a stack dim is deep ``cache_spec``, which
        finds the batch dim by size, cuts that stack dim in the batch's
        place, where a rank holds its rows of the batch as at any other
        size;
      * where ``model`` divides the SSM conv state's window (d_conv - 1
        rows: a model axis of 3) ``cache_spec`` cuts the window, where a
        rank holds every row of it for the channels it computes.

    An encoder-decoder's cross cache (``cross_k``, ``cross_v`` [L, B, F,
    H, D]) follows ``cache_spec``: under the plans that shard weights,
    when ``model`` divides the frames, a rank holds a block of the
    frames of every head (``frame_blocks``).

    ``stage_layers`` (pipeshard): the layers (the hybrid family's groups)
    of each chunk, ``v`` chunks a stage for ``v * stages`` entries; None
    is the even split, one chunk a stage."""

    def __init__(self, model: Model, plan: Union[str, Plan], mesh: Mesh, *,
                 max_len: int, window: int = 0, stage_layers=None):
        plan = get_plan(plan) if isinstance(plan, str) else plan
        cfg = model.cfg
        self.model, self.plan, self.mesh = model, plan, mesh
        self.max_len, self.window = max_len, window
        self.stage_layers = stage_layers
        self._shapes = model.init(torch.Generator(), device="meta")
        self.param_specs = plan.param_specs(self._shapes, cfg, mesh)
        self.local_specs = self.param_specs
        self.model_axis = _model_axis(mesh, self.param_specs, cfg) \
            if plan.shards_weights else None
        data = plan.mesh_axes(mesh)["data"]
        self.fsdp = FsdpGather(self.param_specs, mesh, data, ()) \
            if plan.fsdp else None
        cap = min(max_len, window) if window else max_len
        n = mesh.shape.get(MODEL_AXIS, 1)
        self.blocks: Optional[RingBlocks] = None
        if self.model_axis is not None:
            self.blocks = RingBlocks(mesh.group(MODEL_AXIS), n,
                                     mesh.coord[MODEL_AXIS]) \
                if cap >= n and cap % n == 0 else WHOLE_RING
        self.channel_blocks = n if cfg.ssm is not None and \
            self.model_axis is not None and self.model_axis.d_inner else 1
        # the cross cache's frames cut over ``model`` (in one block on a
        # model axis of one), as ``cache_spec`` cuts them
        self.frames_cut = cfg.family == "encdec" and \
            self.model_axis is not None and cfg.enc_seq_len % n == 0
        self.frame_blocks = n if self.frames_cut else 1
        self.server = None
        self.stage_rows = None
        if plan.pipeline:
            self._stages(stage_layers)
        elif stage_layers is not None:
            raise ValueError(f"stage_layers under {plan.name!r}: only a "
                             f"pipeline plan has stages")

    def _stages(self, stage_layers) -> None:
        """The stage's layers (``stage_rows``), its specs of them and its
        ``StageServer``."""
        mesh, cfg = self.mesh, self.model.cfg
        if STAGE_AXIS not in mesh.shape:
            raise ValueError(f"plan {self.plan.name!r} needs a mesh with a "
                             f"{STAGE_AXIS!r} axis (launch.mesh"
                             f".make_pipeline_mesh), got {mesh.axis_names}")
        S = mesh.shape[STAGE_AXIS]
        stack = self._shapes["layers"]
        v = 1
        if stage_layers is not None:
            v = max(len(stage_layers) // S, 1)
            if len(stage_layers) != v * S:
                raise ValueError(f"stage_layers {tuple(stage_layers)}: not "
                                 f"a whole number of chunks a stage for "
                                 f"{S} stages")
        schedule = "gpipe" if v == 1 else f"interleaved{v}"
        split = validate_stages(cfg, stack, S, stage_layers,
                                schedule=schedule) \
            or (stack_length(cfg, stack) // S,) * S
        self.stage_rows = stage_rows(split, S, v, mesh.coord[STAGE_AXIS])
        # the local layout: a stage holds its rows of every stack dim
        self.local_specs = stage_local_specs(self.param_specs)
        self.server = StageServer(self.model, split, mesh.coord[STAGE_AXIS],
                                  mesh.members(STAGE_AXIS),
                                  mesh.group(STAGE_AXIS))

    # ------------------------------------------------------------- #
    def shard_params(self, params):
        """This rank's blocks of the full params (under pipeshard, of its
        stage's rows of the stacks, ``core.pipeline.held_rows``, and of
        every leaf outside them)."""
        if self.stage_rows is None:
            return shard_tree(params, self.param_specs, self.mesh)
        stage = self.mesh.coord[STAGE_AXIS]

        def cut(path, t, spec):
            rows = held_rows(path, self.stage_rows, stage, t.shape[0])
            # one stage holds every row: the leaf itself, as a flat
            # plan's blocks on a mesh of one are the params
            if rows is not None and len(rows) < t.shape[0]:
                t = t.index_select(0, torch.as_tensor(
                    rows, dtype=torch.long, device=t.device))
            return slice_leaf(t, spec, self.mesh)

        return tree_map_with_path(cut, params, self.local_specs)

    def rows(self, batch_size: int) -> Tuple[int, int]:
        """(first, count) of this rank's rows of a batch."""
        axes = self.plan.batch_axes(self.mesh, batch_size)
        count = batch_size // (self.mesh.count(axes) if axes else 1)
        return (self.mesh.index(axes) * count if axes else 0), count

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of ``batch`` (``core.steps._local_rows``)."""
        return _local_rows(batch, self.plan.batch_spec(batch, self.mesh),
                           self.mesh, 1, self.model.device)

    def gather_rows(self, t: torch.Tensor, batch_size: int) -> torch.Tensor:
        """The whole batch of ``t`` (this rank's rows first on dim 0) on
        every rank, the rows in order."""
        axes = self.plan.batch_axes(self.mesh, batch_size)
        if not axes or self.mesh.count(axes) == 1:
            return t
        return all_gather(t, self.mesh.group(axes), 0)

    def check_cache_layout(self, batch_size: int, *, kv_dtype: str = "fp32",
                           slots: bool = False) -> None:
        """Hold the layout ``init_cache`` builds for ``batch_size`` rows
        to ``cache_spec``'s where the two speak of the same dims: on each
        leaf whose batch dim ``cache_spec`` finds (it finds the batch dim
        by size; the true one is the dim that differs between the caches
        of B and B + 1 rows), the ring's cut over ``model``, the SSM
        state's ``h`` cut with its channels and the cross cache's frames
        cut over ``model``.  Where ``cache_spec`` takes
        another dim for the batch (a stack as deep as the batch) or cuts
        the SSM conv state's window over ``model``, the runtime keeps its
        own layout: the two differ in memory, not in numbers (ROADMAP
        queue 3, "Facts")."""
        m = self.model
        init = m.init_slot_cache if slots else m.init_cache
        kw = dict(window=self.window, kv_dtype=kv_dtype)
        shapes = init(batch_size, self.max_len, device="meta", **kw)
        wider = init(batch_size + 1, self.max_len, device="meta", **kw)
        specs = self.plan.cache_spec(shapes, m.cfg, self.mesh, batch_size)
        cut = self._ring_cut()
        n = self.mesh.shape.get(MODEL_AXIS, 1)

        def check(name, leaf, other, spec):
            if name == "index" or name == "conv":
                return
            at = next(i for i, s in enumerate(leaf.shape) if s == batch_size)
            want = next(i for i, (a, b) in enumerate(zip(leaf.shape,
                                                         other.shape))
                        if a != b)
            if at != want:
                return
            on_model = len(spec) > at + 1 and spec[at + 1] == MODEL_AXIS
            if name == "h" and n > 1 and on_model != \
                    (self.channel_blocks > 1):
                raise AssertionError(f"h: cache_spec {spec} against the "
                                     f"channels' cut {self.channel_blocks}")
            if name in _CROSS_LEAVES and on_model != self.frames_cut:
                raise AssertionError(f"{name}: cache_spec {spec} against "
                                     f"the frames' cut {self.frame_blocks}")
            if name not in _SSM_LEAVES + _CROSS_LEAVES and on_model != cut:
                raise AssertionError(f"{name}: cache_spec {spec} against "
                                     f"the ring's blocks {self.blocks}")

        map_cache(check, shapes, wider, specs)

    def _ring_cut(self) -> bool:
        """Whether a rank holds a block of the ring (not the whole)."""
        return self.blocks is not None and self.blocks.group is not None

    def init_cache(self, batch_size: int, *, kv_dtype: str = "fp32",
                   slots: bool = False) -> Cache:
        """This rank's rows, block, SSM channels, frames and (under
        pipeshard) stage layers of a fresh cache of ``batch_size`` rows
        (``slots``: ``Model.init_slot_cache``'s per-slot cache), at every
        batch size and on every model axis (``check_cache_layout``)."""
        self.check_cache_layout(batch_size, kv_dtype=kv_dtype, slots=slots)
        init = self.model.init_slot_cache if slots else self.model.init_cache
        return init(batch_size, self.max_len, rows=self.rows(batch_size)[1],
                    seq_blocks=self.blocks.size if self._ring_cut() else 1,
                    channel_blocks=self.channel_blocks,
                    frame_blocks=self.frame_blocks,
                    depth=None if self.stage_rows is None
                    else len(self.stage_rows), window=self.window,
                    kv_dtype=kv_dtype)

    # ------------------------------------------------------------- #
    def prefill(self, params, batch, cache: Cache, *, window: int,
                last_pos) -> Tuple[torch.Tensor, Cache]:
        """(logits of this rank's rows, filled cache) of this rank's rows
        ``batch``."""
        if self.server is not None:
            return self.server.prefill(params, batch, cache, window=window,
                                       last_pos=last_pos, blocks=self.blocks)
        return self.model.prefill(params, batch, cache, window=window,
                                  last_pos=last_pos, blocks=self.blocks)

    def decode(self, params, cache: Cache, tokens, *, window: int
               ) -> Tuple[torch.Tensor, Cache]:
        """(logits, cache) of one decode step of this rank's rows."""
        if self.server is not None:
            return self.server.decode(params, cache, tokens, window=window,
                                      blocks=self.blocks)
        return self.model.decode_step(params, cache, tokens, window=window,
                                      blocks=self.blocks)


@contextmanager
def _bound(model: Model, plan: Optional[ServePlan], batch_size: int = 0):
    """The model's plan attributes set to ``plan``'s for a step of
    ``batch_size`` rows (cleared on one device), and given back their
    values after it: a model may serve under several plans and on one
    device, and train under a ``core.steps.PlanStep``, which sets them
    once.  The MoE family routes as the reference's
    ``_set_moe_dispatch``: each batch rank's tokens on their own, or
    under pipeshard the whole batch as one (``core.steps._dispatch``)."""
    saved = model.model_axis, model.fsdp, model.dispatch
    model.model_axis, model.fsdp, model.dispatch = None, None, None
    if plan is not None:
        model.model_axis, model.fsdp = plan.model_axis, plan.fsdp
        model.dispatch = _dispatch(
            model, plan.mesh, plan.plan.batch_axes(plan.mesh, batch_size),
            whole=plan.plan.pipeline)
    try:
        yield
    finally:
        model.model_axis, model.fsdp, model.dispatch = saved


def _index_rows(cache: Cache, first: int, count: int) -> Cache:
    """The per-slot cache with each ``index`` leaf's trailing slot axis
    narrowed to this rank's rows (views)."""
    return map_cache(lambda name, leaf: leaf[..., first:first + count]
                     if name == "index" else leaf, cache)


@torch.no_grad()
def prefill_step(model: Model, params, batch, cache: Cache, *,
                 window: int = 0, last_pos=None,
                 plan: Optional[ServePlan] = None):
    """(logits [B, V], filled cache).  ``last_pos`` (continuous
    batching) reads the logits of a bucket-padded prompt's true last
    token; the pad tail after it is causally invisible.  ``plan``: the
    whole batch in, this rank's rows and block of the cache, the whole
    batch's logits out."""
    if plan is None:
        with _bound(model, None):
            return model.prefill(params, batch, cache, window=window,
                                 last_pos=last_pos)
    B = torch.as_tensor(batch["tokens"]).shape[0]
    with _bound(model, plan, B):
        logits, cache = plan.prefill(params, plan.local_batch(batch), cache,
                                     window=window, last_pos=last_pos)
    return plan.gather_rows(logits, B), cache


def _decode(model: Model, params, cache: Cache, tokens, window: int,
            plan: Optional[ServePlan]):
    """(logits of the whole batch, new cache) of one decode step of this
    rank's rows (``cache`` already this rank's)."""
    if plan is None:
        with _bound(model, None):
            return model.decode_step(params, cache, tokens, window=window)
    first, count = plan.rows(tokens.shape[0])
    with _bound(model, plan, tokens.shape[0]):
        logits, cache = plan.decode(params, cache,
                                    tokens[first:first + count],
                                    window=window)
    return plan.gather_rows(logits, tokens.shape[0]), cache


@torch.no_grad()
def serve_step(model: Model, params, cache: Cache, tokens, *,
               window: int = 0, plan: Optional[ServePlan] = None):
    """One new token against the cache: (logits, greedy next token
    [B, 1] int32, cache)."""
    tokens = torch.as_tensor(tokens, device=model.device)
    logits, cache = _decode(model, params, cache, tokens, window, plan)
    next_tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    return logits, next_tok, cache


@torch.no_grad()
def decode_slots_step(model: Model, params, cache: Cache, tokens, live, *,
                      window: int = 0, pad_id: int = 0,
                      plan: Optional[ServePlan] = None):
    """One decode step over the persistent slot cache.  Dead slots
    (``live`` False) emit ``pad_id`` and keep their ring indices (the
    leaves named ``index``), so an evicted slot's KV ring cannot move
    before the insert that recycles it.  Its SSM state may drift, as in
    the reference: the insert overwrites it.  ``plan``: every rank holds
    the whole index; its rows' new indices are gathered into it."""
    tokens = torch.as_tensor(tokens, device=model.device)
    first, count = (0, tokens.shape[0]) if plan is None \
        else plan.rows(tokens.shape[0])
    mine = cache if plan is None else _index_rows(cache, first, count)
    logits, new = _decode(model, params, mine, tokens, window, plan)
    rows = live[first:first + count]

    def freeze(name, n, o):
        """decode made new index tensors; ``mine`` still holds the old."""
        if name != "index":
            return n
        kept = torch.where(rows, n, o)
        if plan is None:
            return kept
        return plan.gather_rows(kept.movedim(-1, 0).contiguous(),
                                tokens.shape[0]).movedim(0, -1)

    new = map_cache(freeze, new, mine)
    next_tok = torch.where(live[:, None],
                           torch.argmax(logits, dim=-1)[:, None],
                           torch.full_like(live[:, None], pad_id,
                                           dtype=torch.long))
    return logits, next_tok.to(torch.int32), new


@torch.no_grad()
def teacher_forced(model: Model, params, local, batch, tokens,
                   plan: ServePlan, *, kv_dtype: str = "fp32"):
    """Prefill and every decode step of ``batch`` under ``plan`` (with
    this rank's blocks ``local`` of the full ``params``) beside one
    device, both fed the one-device greedy ``tokens`` [B, n] in
    lockstep (teacher-forced, so the two paths see the same inputs even
    where their greedy tokens part).  Returns (the largest |logit
    difference|, the largest |one-device logit|, whether every step's
    logits were bit-equal)."""
    B = tokens.shape[0]
    caches = [model.init_cache(B, plan.max_len, window=plan.window,
                               kv_dtype=kv_dtype),
              plan.init_cache(B, kv_dtype=kv_dtype)]
    err = scale = 0.0
    same = True
    for i in range(tokens.shape[1]):
        out = []
        for j, (p, sp) in enumerate(((params, None), (local, plan))):
            if i == 0:
                lg, caches[j] = prefill_step(model, p, batch, caches[j],
                                             window=plan.window, plan=sp)
            else:
                tok = torch.as_tensor(tokens[:, i - 1:i], device=model.device)
                lg, _, caches[j] = serve_step(model, p, caches[j], tok,
                                              window=plan.window, plan=sp)
            out.append(lg)
        want, got = out
        err = max(err, float((got - want).abs().max()))
        scale = max(scale, float(want.abs().max()))
        same = same and torch.equal(got, want)
    return err, scale, same


@torch.no_grad()
def insert_step(dst: Cache, src: Cache, slot: int, length: int, *,
                plan: Optional[ServePlan] = None, slots: int = 0) -> Cache:
    """Scatter a freshly prefilled batch-1 cache ``src`` into slot
    ``slot`` of the per-slot cache ``dst``, in place, and set the slot's
    ring indices to the request's true ``length`` (the prefill cache
    holds the padded bucket length), so the pad tail stays masked and the
    next decode append overwrites its first position.

    As the reference's ``build_insert_step`` does, a leaf's batch axis is
    the first axis on which ``dst`` and ``src`` differ in size: 1 for
    ``[L, B, ...]`` leaves, 2 for the hybrid family's ``[G, k, B, ...]``
    SSM state.  With one slot the shapes agree and the whole leaf is
    the slot.  ``plan``: the rank whose rows of the cache's ``slots``
    slots hold the slot writes it, its block of the ring from its block
    of ``src``; every rank sets the slot's index."""
    at, mine = slot, True
    if plan is not None:
        first, count = plan.rows(slots)
        at, mine = slot - first, first <= slot < first + count

    def put(name, d, s):
        if name == "index":
            d[..., slot] = length
            return d
        if not mine:
            return d
        axis = next((i for i, (m, n) in enumerate(zip(d.shape, s.shape))
                     if m != n), None)
        if axis is None:
            d.copy_(s)
        else:
            d.select(axis, at).copy_(s.select(axis, 0))
        return d

    return map_cache(put, dst, src)
