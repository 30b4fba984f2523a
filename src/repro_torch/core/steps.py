"""Train steps: on one device, and under every plan of ``PLANS`` (data,
zero2, shard, shard_zero, fsdp, pipeshard) on ``torch.distributed``, for
the dense, vision-language, MoE, SSM, hybrid and encoder-decoder
families (port of ``repro/core/steps.py:build_train_step``).

``build_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)`` with the reference's metric keys.  Gradients are
taken with ``torch.autograd.grad`` on detached copies of the fp32
leaves, so the caller's params are left as they were; ``grad_accum > 1``
runs the batch as sequential microbatches and sums their gradients in
fp32, as the reference's ``lax.scan`` does.  ``donate`` updates the
params and the optimizer state in place, as the reference's jitted step
donates them (``optim.adamw_update``).

Under a plan (``PlanStep``) each rank holds its blocks of the params and
of the optimizer state, cut by the plan's specs (``core.plans``), and
takes its slice of the global batch by its place on the batch axes.
Of each of the step's microbatches (``grad_accum``'s, a pipeline's) a
rank takes its part on the batch axes: the reference's microbatch i is
the global rows ``[i B/n, (i+1) B/n)``, split over the data axes.  The
loss divides by the token count of the whole batch, so the ranks'
gradients add up to the one-device gradient.  Where the reference's XLA
inserts the collectives, here they are explicit (``core.sharding``):

  * data       — the gradients are all-reduced over the batch axes;
  * zero2      — reduce-scattered over the data axes onto the optimizer
                 blocks (and all-reduced over the model axis when the
                 batch is split over it too); AdamW updates the blocks
                 and the new params are all-gathered;
  * shard      — the dense layers run tensor-parallel over ``model``
                 (``Model.model_axis``); the gradients of the blocks and
                 of the whole leaves are all-reduced over the data axes;
  * shard_zero — both: a leaf cut on ``model`` is gathered whole, then
                 reduce-scattered onto its optimizer block, whose specs
                 (the reference's) span the data axes only;
  * fsdp       — shard, with every leaf also cut over the data axes
                 (``add_fsdp_axis``) and the optimizer state on the same
                 blocks: each leaf is gathered at its use, a layer's
                 inside the layer loop (``core.sharding.FsdpGather``), and
                 its gradient reduce-scattered back onto the block, which
                 AdamW updates where it lies.  The residual stream stays
                 whole on every rank: the reference's ``resid_pspec``
                 under fsdp only places activations and changes no
                 number.

The families under the plans that shard weights (``_model_axis``): the
dense blocks (the hybrid's shared one too) cut heads and MLP; the MoE
family its experts when ``n_experts`` divides the model axis, each
batch rank routing its own tokens with its own capacity and adding the
mean of the ranks' auxes (``models.moe``); the SSM family ``d_inner``
(``models.ssm``).

Under pipeshard (``PipelineStep``) each stage rank holds the layers of
its chunks and every leaf outside the stack, both cut over ``model`` as
under shard, and ``core.pipeline.StageRunner`` runs the microbatches
through the stages in the schedule's order, backwards included:

  * the gradients of a stage's layers are all-reduced over the data
    axes; those of the leaves every stage holds (the embedding, the
    position table, the final norm, the head) over the stage and data
    axes, a stage that does not use a leaf adding zeros;
  * AdamW's norm sums a stage's layers over the stage axis and takes
    every other leaf once (``update_specs``);
  * the MoE family routes each global microbatch as one over the data
    axes, and its aux is the sum over the stages and microbatches
    divided by their count, as the reference's pipeline takes it; the
    hybrid family's groups are the stack, and its shared block runs in
    every stage.

The vision-language family (phi-3-vision) is the dense family behind a
projector: a batch carries ``patch_embeds`` [B, P, vision_dim], cut with
the tokens over the batch axes (``_local_rows``, the ``grad_accum``
microbatches), and the projector's leaves are whole under every plan
but fsdp, which gathers them at their use.  Under shard and shard_zero
every model rank computes the projector whole on the whole residual
gradient (the layers' f sums it over the axis), so its gradient is one
device's, reduced over the data axes as ``pos_embed``'s is where its
table stays whole; under pipeshard the first stage holds its gradient
and the others add zeros.

The encoder-decoder family (whisper): a batch carries ``frames`` [B, F,
d], cut with the tokens as ``patch_embeds`` are.  The encoder's layers
and every decoder layer's cross-attention take the dense blocks' cut of
the heads and the MLP (``_model_axis``), the encoder's output entering
the decoder layers through one f (``Model.encoder_output``), so its
gradient is summed over the layers, then over the model axis; the
encoder's position table is cut over no model axis (the copied axis map
has no ``embed_d``).  Under pipeshard the
first stage holds the encoder's stack whole and the others none of it
(``core.pipeline.held_rows``); it runs the encoder once a microbatch
and its output travels with the hidden states to every chunk
(``core.pipeline.StageRunner``); the encoder's gradients are reduced
over the data axes (its stack) or, as the embedding's, over the stage
and data axes (its norm and position table, which every stage holds).
Multi-head Latent Attention (MiniCPM3, DeepSeek-V2) cuts its heads as
the dense blocks do: ``w_uq``, ``w_uk``, ``w_uv`` and ``wo`` on the
heads, the latent's leaves (``w_dq``, ``q_norm``, ``w_dkv``,
``kv_norm``, ``w_kr``) whole on every rank, entering through f
(``models.attention``); DeepSeek-V2's top-6 combine adds each token's
contributions in one device's order on every rank (``models.moe``).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.core.costmodel import parse_schedule
from repro_torch.core.pipeline import (
    STACKS, StageRunner, held_rows, pipeline_split, stage_rows,
)
from repro_torch.core.plans import MODEL_AXIS, STAGE_AXIS, Plan, get_plan
from repro_torch.core.sharding import (
    FsdpGather, Mesh, ModelAxis, all_gather, all_reduce, gather_leaf,
    gather_tree, reduce_scatter, shard_tree, slice_leaf, spec_axes, subtree,
    tree_map_with_path,
)
from repro_torch.models.model import Model, scored_labels
from repro_torch.models.moe import Dispatch
from repro_torch.optim import AdamWState, adamw_update, lr_at
from repro_torch.optim.adamw import tree_leaves, tree_map

METRIC_KEYS = ("ce", "aux", "zloss", "accuracy", "tokens")
# metrics that are sums over the batch's ranks (``tokens`` is global)
_SUMMED = ("loss", "ce", "aux", "zloss", "accuracy")


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, all detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def _grad_fn(model: Model, tcfg: TrainConfig, loss_fn) -> Callable:
    """(loss, metrics, grads) of a batch, in ``grad_accum`` microbatches."""

    def grad_fn(params, batch):
        A = tcfg.grad_accum
        if A <= 1:
            return value_and_grad(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into grad_accum={A} "
                             f"microbatches")
        b = B // A
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        loss_sum, m_sum = zero, {k: zero for k in METRIC_KEYS}
        for a in range(A):
            mb = {k: v[a * b:(a + 1) * b] for k, v in batch.items()}
            loss, metrics, g = value_and_grad(loss_fn, params, mb)
            # in place: one fp32 copy of the gradients besides a
            # microbatch's
            tree_map(lambda acc, gg: acc.add_(gg.float()), g_sum, g)
            del g
            loss_sum = loss_sum + loss
            m_sum = {k: m_sum[k] + metrics[k] for k in METRIC_KEYS}
        metrics = {k: v / A for k, v in m_sum.items()}
        metrics["tokens"] = metrics["tokens"] * A
        return loss_sum / A, metrics, tree_map(lambda g: g.div_(A), g_sum)

    return grad_fn


def build_train_step(model: Model, tcfg: TrainConfig, *,
                     plan: Union[None, str, Plan] = None,
                     mesh: Optional[Mesh] = None, stage_layers=None,
                     schedule: str = "gpipe",
                     carrier_dtype=torch.float32,
                     donate: bool = False) -> Callable:
    """The one-device step for ``plan=None``; else a ``PlanStep`` over
    ``mesh`` (a ``core.sharding.Mesh``, e.g. from
    ``launch.mesh.make_host_mesh``), or for a pipeline plan a
    ``PipelineStep`` over a staged mesh (``launch.mesh
    .make_pipeline_mesh``) with ``tcfg.microbatches``, the per-chunk
    ``stage_layers`` (None: the even split) and the tick-order
    ``schedule`` (``core.costmodel.SCHEDULES``), the reference's
    keywords.  ``donate``: the step updates the params and optimizer
    state it is given in place."""
    model.model_axis = model.fsdp = model.dispatch = None
    if plan is None:
        return _one_device_step(model, tcfg, donate)
    plan = get_plan(plan) if isinstance(plan, str) else plan
    if mesh is None:
        raise ValueError(f"plan {plan.name!r} needs a mesh "
                         f"(repro_torch.launch.mesh.make_host_mesh)")
    if plan.pipeline:
        return PipelineStep(model, tcfg, plan, mesh,
                            stage_layers=stage_layers, schedule=schedule,
                            carrier_dtype=carrier_dtype, donate=donate)
    return PlanStep(model, tcfg, plan, mesh, donate=donate)


def _one_device_step(model: Model, tcfg: TrainConfig,
                     donate: bool = False) -> Callable:
    grad_fn = _grad_fn(model, tcfg, partial(model.loss, remat=tcfg.remat))

    def step(params, opt_state, batch) -> tuple:
        loss, metrics, grads = grad_fn(params, batch)
        lr = lr_at(opt_state.step, tcfg)
        new_params, new_opt, stats = adamw_update(grads, opt_state, params,
                                                  tcfg, lr, donate=donate)
        metrics: Dict[str, torch.Tensor] = dict(metrics, loss=loss, **stats)
        return new_params, new_opt, metrics

    return step


def _cut_dim(spec) -> Tuple[Optional[int], Tuple[str, ...]]:
    """(dim, axes) of a spec that cuts one dim; (None, ()) for none."""
    for dim, e in enumerate(spec):
        if e is not None:
            return dim, (e if isinstance(e, tuple) else (e,))
    return None, ()


def _model_axis(mesh: Mesh, specs, cfg) -> Optional[ModelAxis]:
    """What the specs cut over the ``model`` axis, family by family: the
    dense blocks' heads and MLP (the layers', or the hybrid's shared
    block's; the encoder-decoder's self-attention, whose cut its
    cross-attention and its encoder's layers share; MLA's heads, those of
    ``w_uq``, with no kv heads to cut), the MoE experts and
    shared experts, and the SSM leaves (``d_inner``: the channels cut
    whole, which for Mamba2 needs the heads to divide the axis too)."""
    if MODEL_AXIS not in mesh.shape:
        return None
    M = mesh.shape[MODEL_AXIS]

    def cut(spec) -> bool:
        return MODEL_AXIS in spec_axes(spec)

    layers = specs["layers"]
    dense = specs.get("shared", layers)
    kw = {}
    attn = "self_attn" if "self_attn" in dense else "attn"
    if attn in dense:
        kw.update(heads=cut(dense[attn]["wq"]),
                  kv_heads=cut(dense[attn]["wk"]))
    elif "mla" in dense:
        # MLA's heads: w_uq's, which w_uk, w_uv and wo share
        kw["heads"] = cut(dense["mla"]["w_uq"])
    if "mlp" in dense:
        kw["mlp"] = cut(dense["mlp"]["w_up"])
    if "moe" in layers:
        moe = layers["moe"]
        kw.update(experts=cut(moe["w_up"]),
                  shared_experts="shared_up" in moe
                  and cut(moe["shared_up"]))
    mamba, depth = (layers["blocks"]["mamba"], 2) if "blocks" in layers \
        else (layers.get("mamba"), 1)
    if mamba is not None:
        s = cfg.ssm
        di = s.expand * cfg.d_model
        heads = s.version == 1 or (s.n_heads or di // s.head_dim) % M == 0
        kw.update(d_inner=cut(mamba["out_proj"]) and heads,
                  ssm_cut=tuple((k, spec.index(MODEL_AXIS) - depth)
                                for k, spec in mamba.items() if cut(spec)))
    return ModelAxis(group=mesh.group(MODEL_AXIS), size=M,
                     rank=mesh.coord[MODEL_AXIS],
                     vocab=cut(specs["embed"]["table"]),
                     positions="pos_embed" in specs
                     and cut(specs["pos_embed"]["table"]),
                     heads=kw.pop("heads", False),
                     kv_heads=kw.pop("kv_heads", False),
                     mlp=kw.pop("mlp", False), **kw)


def _local_rows(batch, specs, mesh: Mesh, groups: int, dev
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global ``batch``: of each of ``groups``
    consecutive groups of rows (the step's microbatches), its part on
    the batch axes of ``specs``, the groups back to back."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=dev)
        spec = specs[k]
        n = v.shape[0]
        parts = mesh.count(spec_axes(spec)) if spec else 1
        if n % (groups * parts):
            raise ValueError(f"batch {n} does not split into {groups} "
                             f"microbatches over {parts} batch ranks")
        v = v.reshape((groups, n // groups) + tuple(v.shape[1:]))
        out[k] = slice_leaf(v, (None,) + tuple(spec), mesh).flatten(0, 1)
    return out


def _dispatch(model: Model, mesh: Mesh, axes, whole: bool
              ) -> Optional[Dispatch]:
    """The MoE family's routing over the batch ``axes`` (None for the
    other families, or where no axis splits the batch)."""
    if model.cfg.family != "moe" or not axes:
        return None
    return Dispatch(group=mesh.group(axes), size=mesh.count(axes),
                    rank=mesh.index(axes), whole=whole)


class PlanStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    under ``plan`` on ``mesh``.

    ``params`` are this rank's blocks by ``param_specs`` (``shard_params``
    cuts them from the full tree), ``opt_state`` its blocks by
    ``opt_specs`` (``init_opt_state``, ``shard_opt_state``), ``batch``
    the global batch, of which the step takes this rank's slice.  The
    metrics are those of the whole batch.  ``gather_params`` and
    ``gather_opt_state`` give back the one-device layout on every rank.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, plan: Plan,
                 mesh: Mesh, *, donate: bool = False):
        self.model, self.tcfg, self.plan, self.mesh = model, tcfg, plan, mesh
        self.donate = donate
        cfg = model.cfg
        self._shapes = model.init(torch.Generator(), device="meta")
        self.param_specs = plan.param_specs(self._shapes, cfg, mesh)
        self.opt_specs = plan.opt_specs(self._shapes, cfg, mesh)
        # the layout AdamW updates in: the optimizer's blocks (fsdp's are
        # the params' own)
        self.update_specs = self.opt_specs if plan.zero_sharding \
            else self.param_specs
        self.data_axes = plan.mesh_axes(mesh)["data"]
        model.model_axis = _model_axis(mesh, self.param_specs, cfg) \
            if plan.shards_weights else None

    # ------------------------------------------------------------- #
    def shard_params(self, params):
        return shard_tree(params, self.param_specs, self.mesh)

    def gather_params(self, params):
        return gather_tree(params, self.param_specs, self.mesh)

    def init_opt_state(self) -> AdamWState:
        dev = self.model.device
        local = shard_tree(self._shapes, self.opt_specs, self.mesh)

        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=dev)

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, local), v=tree_map(zeros, local))

    def shard_opt_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step,
                          m=shard_tree(state.m, self.opt_specs, self.mesh),
                          v=shard_tree(state.v, self.opt_specs, self.mesh))

    def gather_opt_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step,
                          m=gather_tree(state.m, self.opt_specs, self.mesh),
                          v=gather_tree(state.v, self.opt_specs, self.mesh))

    # ------------------------------------------------------------- #
    def batch_axes(self, global_batch: int) -> Tuple[str, ...]:
        return self.plan.batch_axes(self.mesh, global_batch)

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global ``batch``: its part of each of
        the ``grad_accum`` microbatches (``_local_rows``)."""
        return _local_rows(batch, self.plan.batch_spec(batch, self.mesh),
                           self.mesh, max(self.tcfg.grad_accum, 1),
                           self.model.device)

    def _reduce(self, g, p_spec, u_spec, axes):
        """One leaf's gradient, partial over the batch ``axes``, onto its
        update block, summed."""
        mesh = self.mesh
        if self.plan.fsdp:
            # a leaf cut over the data axes comes summed onto its block
            # from its gather's backward; one they leave whole, as shard
            if self.model.fsdp.cut_dim(p_spec) is None and axes:
                all_reduce(g, mesh.group(axes))
            return g
        if not self.plan.zero_sharding:
            if axes:
                all_reduce(g, mesh.group(axes))
            return g
        if p_spec != u_spec:
            g = gather_leaf(g, p_spec, mesh)      # whole over model
        dim, zero = _cut_dim(u_spec)
        scatter = bool(zero) and all(a in axes for a in zero)
        if scatter:
            g = reduce_scatter(g, mesh.group(zero), dim)
            axes = tuple(a for a in axes if a not in zero)
        if axes:
            all_reduce(g, mesh.group(axes))
        if zero and not scatter:
            g = slice_leaf(g, u_spec, mesh)
        return g

    def grads(self, params, batch):
        """(loss, metrics, grads) of the global ``batch``: the whole
        batch's loss and metrics, and the grads summed over the batch's
        ranks, this rank's blocks in the update layout
        (``update_specs``)."""
        axes = self.batch_axes(batch["tokens"].shape[0])
        group = self.mesh.group(axes) if axes else None
        model = self.model
        model.dispatch = _dispatch(model, self.mesh, axes, whole=False)
        if self.plan.fsdp:
            model.fsdp = FsdpGather(self.param_specs, self.mesh,
                                    self.data_axes, axes)
        loss_fn = partial(model.loss, remat=self.tcfg.remat,
                          batch_group=group)
        loss, metrics, grads = _grad_fn(self.model, self.tcfg, loss_fn)(
            params, self.local_batch(batch))
        grads = tree_map_with_path(
            lambda _, g, ps, us: self._reduce(g, ps, us, axes), grads,
            self.param_specs, self.update_specs)
        if group is not None:
            sums = all_reduce(torch.stack(
                [loss] + [metrics[k].float() for k in _SUMMED[1:]]), group)
            loss = sums[0]
            metrics = dict(metrics, **dict(zip(_SUMMED[1:], sums[1:])))
        return loss, metrics, grads

    def __call__(self, params, opt_state, batch):
        return self.apply(params, opt_state, *self.grads(params, batch))

    def apply(self, params, opt_state, loss, metrics, grads):
        """The AdamW update of ``grads`` (from ``grads``): the step's
        output."""
        lr = lr_at(opt_state.step, self.tcfg)
        mesh = self.mesh

        # zero plans: params to the optimizer's blocks and back
        def to_update(_, p, ps, us):
            return p if ps == us else slice_leaf(gather_leaf(p, ps, mesh),
                                                 us, mesh)

        def from_update(_, u, ps, us):
            return u if ps == us else slice_leaf(gather_leaf(u, us, mesh),
                                                 ps, mesh)

        p_u = tree_map_with_path(to_update, params, self.param_specs,
                                 self.update_specs)
        new_u, new_opt, stats = adamw_update(
            grads, opt_state, p_u, self.tcfg, lr, specs=self.update_specs,
            mesh=mesh, donate=self.donate)
        new_params = tree_map_with_path(from_update, new_u, self.param_specs,
                                        self.update_specs)
        return new_params, new_opt, dict(metrics, loss=loss, **stats)


def _is_stacked(path: str) -> bool:
    """A leaf of a stack whose rows a pipeline stage holds
    (``core.pipeline.held_rows``)."""
    return path.startswith(STACKS)


def stage_local_specs(param_specs):
    """A pipeline's local layout's cuts: the plan's specs with no stack
    dim cut over the stage axis (a stage holds its rows of the first:
    ``core.pipeline.held_rows``)."""
    return tree_map_with_path(
        lambda _, spec: tuple(None if e == STAGE_AXIS else e for e in spec),
        param_specs)


class PipelineStep:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    under a pipeline plan on a ``(stage, data, model)`` mesh.

    ``params`` are this rank's in the local layout: the ``layers``
    leaves hold the rows of this stage's chunks back to back
    (``core.pipeline.stage_rows``), an encoder-decoder's encoder stack
    is whole on the first stage and empty on the others
    (``core.pipeline.held_rows``), every leaf cut over ``model`` by
    ``param_specs`` (the reference's ``PartitionSpec``s, whose stack
    dims the local layout replaces by the stage's rows).  ``batch`` is
    the global batch cut into ``tcfg.microbatches``, of each of which
    the step takes this rank's part on the data axes.  The metrics are
    those of the whole batch, on every rank.  ``shard_params`` and
    ``gather_params`` (also for gradients), ``init_opt_state``,
    ``shard_opt_state`` and ``gather_opt_state`` go to and from the
    one-device layout.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, plan: Plan,
                 mesh: Mesh, *, stage_layers=None, schedule: str = "gpipe",
                 carrier_dtype=torch.float32, donate: bool = False):
        if STAGE_AXIS not in mesh.shape:
            raise ValueError(f"plan {plan.name!r} needs a mesh with a "
                             f"{STAGE_AXIS!r} axis (launch.mesh"
                             f".make_pipeline_mesh), got {mesh.axis_names}")
        self.model, self.tcfg, self.plan, self.mesh = model, tcfg, plan, mesh
        self.donate = donate
        cfg = model.cfg
        S = mesh.shape[STAGE_AXIS]
        _, v = parse_schedule(schedule)
        self._shapes = model.init(torch.Generator(), device="meta")
        # the stack: layers, or the hybrid family's groups
        self.split = pipeline_split(cfg, self._shapes["layers"], S,
                                    stage_layers, schedule)
        self.rows = [stage_rows(self.split, S, v, s) for s in range(S)]
        self.stage = mesh.coord[STAGE_AXIS]
        self.param_specs = plan.param_specs(self._shapes, cfg, mesh)
        # the local layout's cuts (no stack dim is cut over the stage
        # axis: the stage holds its rows of the first) and AdamW's (a
        # stage's rows summed over the stage axis in its norm)
        self.local_specs = stage_local_specs(self.param_specs)
        self.update_specs = tree_map_with_path(
            lambda path, spec: (STAGE_AXIS,) + tuple(spec[1:])
            if _is_stacked(path) else spec, self.local_specs)
        model.model_axis = _model_axis(mesh, self.param_specs, cfg) \
            if plan.shards_weights else None
        ranks = mesh.members(STAGE_AXIS)
        self.runner = StageRunner(model, schedule, tcfg.microbatches,
                                  self.split, self.stage, ranks,
                                  remat=tcfg.remat,
                                  carrier_dtype=carrier_dtype)

    # ------------------------------------------------------------- #
    def _held(self, path: str, stage: int):
        """The rows of the leaf at ``path`` that ``stage`` holds, or None
        (``core.pipeline.held_rows``)."""
        if not _is_stacked(path):
            return None
        return held_rows(path, self.rows[stage], stage,
                         subtree(self._shapes, path).shape[0])

    def _local(self, tree):
        """Full leaves -> this rank's, in the local layout."""

        def cut(path, t, spec):
            rows = self._held(path, self.stage)
            if rows is not None:
                t = t.index_select(0, torch.as_tensor(
                    rows, dtype=torch.long, device=t.device))
            return slice_leaf(t, spec, self.mesh)

        return tree_map_with_path(cut, tree, self.local_specs)

    def _gather(self, tree):
        """This rank's leaves in the local layout -> full leaves."""
        mesh = self.mesh
        group = mesh.group(STAGE_AXIS)
        order = [mesh.coord_of(r)[STAGE_AXIS]
                 for r in dist.get_process_group_ranks(group)]

        def whole(path, t, spec):
            t = gather_leaf(t, spec, mesh)
            if not _is_stacked(path) or len(order) == 1:
                return t
            held = [self._held(path, s) for s in range(len(order))]
            most = max(len(r) for r in held)
            pad = t.new_zeros((most - t.shape[0],) + tuple(t.shape[1:]))
            blocks = all_gather(torch.cat([t, pad]), group, 0).view(
                (len(order), most) + tuple(t.shape[1:]))
            out = t.new_empty((subtree(self._shapes, path).shape[0],)
                              + tuple(t.shape[1:]))
            for j, s in enumerate(order):
                rows = torch.as_tensor(held[s], dtype=torch.long,
                                       device=t.device)
                out.index_copy_(0, rows, blocks[j, :len(rows)])
            return out

        return tree_map_with_path(whole, tree, self.local_specs)

    def shard_params(self, params):
        return self._local(params)

    def gather_params(self, params):
        return self._gather(params)

    def init_opt_state(self) -> AdamWState:
        dev = self.model.device
        local = self._local(self._shapes)

        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=dev)

        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          m=tree_map(zeros, local), v=tree_map(zeros, local))

    def shard_opt_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, m=self._local(state.m),
                          v=self._local(state.v))

    def gather_opt_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, m=self._gather(state.m),
                          v=self._gather(state.v))

    # ------------------------------------------------------------- #
    def batch_axes(self, global_batch: int) -> Tuple[str, ...]:
        return self.plan.batch_axes(self.mesh, global_batch)

    def local_batch(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's rows of the global ``batch``: its part of each
        microbatch, the reference's microbatch i being the global rows
        ``[i B/m, (i+1) B/m)`` (``_local_rows``).  Only the first stage
        runs the encoder: the others take the ``frames``' shape alone
        (``[rows, F, 0]``), which sizes their carriers."""
        if self.stage and "frames" in batch:
            f = batch["frames"]
            batch = dict(batch, frames=torch.empty(tuple(f.shape[:2])
                                                   + (0,)))
        return _local_rows(batch, self.plan.batch_spec(batch, self.mesh),
                           self.mesh, self.tcfg.microbatches,
                           self.model.device)

    def grads(self, params, batch):
        """(loss, metrics, grads) of the global ``batch``: the whole
        batch's loss and metrics, and the grads summed over its
        microbatches and data ranks, in the local layout."""
        mesh = self.mesh
        axes = self.batch_axes(batch["tokens"].shape[0])
        self.model.dispatch = _dispatch(self.model, mesh, axes, whole=True)
        local = self.local_batch(batch)
        count = (scored_labels(self.model.cfg,
                               torch.as_tensor(local["labels"])) >= 0).sum()
        if axes:
            count = all_reduce(count, mesh.group(axes))
        denom = torch.clamp(count, min=1)
        sums, layer_aux, grads = self.runner.run(params, local, denom)
        every = (STAGE_AXIS,) + axes

        def reduce(path, g):
            over = axes if _is_stacked(path) else every
            return all_reduce(g, mesh.group(over)) if over else g

        grads = tree_map_with_path(reduce, grads)
        # the whole batch's token count, once: from the last stage's
        # first batch rank (the sum runs over the data axes too); the
        # MoE family's aux table beside it
        once = self.stage == mesh.shape[STAGE_AXIS] - 1 and \
            (not axes or mesh.index(axes) == 0)
        parts = [sums, (denom if once else 0 * denom).float()[None]]
        if layer_aux is not None:
            parts.append(layer_aux.flatten())
        sums = all_reduce(torch.cat(parts), mesh.group(every))
        loss = sums[0]
        metrics = dict(zip(("ce", "aux", "zloss", "accuracy", "tokens"),
                           sums[1:6]))
        if layer_aux is not None:
            # each (layer, microbatch) entry one stage's value and zeros,
            # summed in one order: the same loss under every schedule
            aux = sums[6:].sum()
            loss, metrics["aux"] = loss + aux, metrics["aux"] + aux
        return loss, metrics, grads

    def apply(self, params, opt_state, loss, metrics, grads):
        """The AdamW update of ``grads`` (from ``grads``): the step's
        output."""
        lr = lr_at(opt_state.step, self.tcfg)
        new_params, new_opt, stats = adamw_update(
            grads, opt_state, params, self.tcfg, lr,
            specs=self.update_specs, mesh=self.mesh, donate=self.donate)
        return new_params, new_opt, dict(metrics, loss=loss, **stats)

    def __call__(self, params, opt_state, batch):
        return self.apply(params, opt_state, *self.grads(params, batch))
