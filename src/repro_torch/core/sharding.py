"""Logical-axis sharding rule engine and the collectives of the plans
(port of ``repro/core/sharding.py``).

Every parameter leaf is matched (by its key path + rank) to a tuple of
*logical* dimension names; a plan then maps logical names to mesh axes.
Leaves with more dims than the rule's base rank are stacked (layer /
group axes) and get the plan's ``stack_axis`` (``None`` for SPMD plans,
``"stage"`` for Pipeshard) prepended.  Assignment is divisibility-aware:
each dim takes its mapped mesh axis only when the size divides; and when
the primary tensor-parallel dim does not divide, a *secondary* dim
(head_dim / embedding-d) picks up the axis so the tensor still shards.

The rules are the reference's, verbatim in meaning.  A spec is a plain
tuple with one entry per leading dim, each a mesh axis name, a tuple of
names (the dim split over several axes, the first major) or ``None``,
with trailing ``None``s dropped: the reference's ``PartitionSpec`` as a
tuple.  Paths are the ``/``-joined keys of the port's nested dicts, the
reference's tree paths.

The runtime half has no reference counterpart, since XLA inserts the
reference's collectives: ``Mesh`` (a grid of ranks with one process
group per set of its axes), ``shard_tree`` / ``gather_tree`` between
full leaves and this rank's slices, the counted collectives and
point-to-point handoffs (``exchange``), and
Megatron's f and g for the tensor-parallel layers (``copy_to_model``,
``reduce_from_model``).  They are explicit ``torch.distributed`` calls,
not DTensor, so the order of every reduction is visible and the same
code runs on gloo and NCCL.
"""
from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Spec = Tuple[Any, ...]

# Secondary names take a mesh axis only when the primary dim of the same
# tensor failed divisibility.
SECONDARY = ("head_dim", "embed_d")

# (path regex, base rank, logical dims) — first match wins.
RULES: Sequence[Tuple[str, int, Tuple[Optional[str], ...]]] = (
    # embeddings / heads
    (r"(embed|lm_head)/table$", 2, ("vocab", "embed_d")),
    (r"pos(_embed)?/table$|pos/table$", 2, (None, "embed_d")),
    # attention (dense / encdec / hybrid-shared)
    (r"/wq$", 3, ("residual", "heads", "head_dim")),
    (r"/w[kv]$", 3, ("residual", "kv_heads", "head_dim")),
    (r"/wo$", 3, ("heads", "head_dim", "residual")),
    (r"/bq$", 2, ("heads", "head_dim")),
    (r"/b[kv]$", 2, ("kv_heads", "head_dim")),
    (r"/bo$", 1, ("residual",)),
    # MLA
    (r"mla/w_dq$", 2, ("residual", None)),
    (r"mla/(q|kv)_norm$", 1, (None,)),
    (r"mla/w_uq$", 3, (None, "heads", "head_dim")),
    (r"mla/w_dkv$", 2, ("residual", None)),
    (r"mla/w_kr$", 2, ("residual", None)),
    (r"mla/w_u[kv]$", 3, ("heads", None, "head_dim")),
    (r"mla/wo$", 3, ("heads", "head_dim", "residual")),
    # dense MLP
    (r"mlp/w_(gate|up)$", 2, ("residual", "mlp")),
    (r"mlp/b_up$", 1, ("mlp",)),
    (r"mlp/w_down$", 2, ("mlp", "residual")),
    (r"mlp/b_down$", 1, ("residual",)),
    # MoE
    (r"moe/router$", 2, ("residual", None)),
    (r"moe/w_(gate|up|down)$", 3, ("expert", None, None)),
    (r"moe/shared_(gate|up)$", 2, ("residual", "mlp")),
    (r"moe/shared_down$", 2, ("mlp", "residual")),
    # Mamba (1 and 2)
    (r"mamba/in_proj$", 2, ("residual", "d_inner")),
    (r"mamba/conv_w$", 2, (None, "d_inner")),
    (r"mamba/conv_b$", 1, ("d_inner",)),
    (r"mamba/x_proj$", 2, ("d_inner", None)),
    (r"mamba/dt_proj$", 2, (None, "d_inner")),
    (r"mamba/dt_bias$", 1, (None,)),
    (r"mamba/A_log$", 2, ("d_inner", None)),   # mamba1 [di, ds]
    (r"mamba/A_log$", 1, (None,)),             # mamba2 [nh]
    (r"mamba/D$", 1, (None,)),
    (r"mamba/norm_scale$", 1, ("d_inner",)),
    (r"mamba/out_proj$", 2, ("d_inner", "residual")),
    # VLM projector
    (r"projector/w1$", 2, (None, "residual")),
    (r"projector/w2$", 2, ("residual", "residual2")),
    # norms / gates / everything else: replicated
)


def logical_spec(path_str: str, ndim: int,
                 *, n_stack: int = 0) -> Tuple[Optional[str], ...]:
    """Logical dims for one leaf. ``n_stack``: how many leading stacked dims
    precede the per-layer parameter (0 for unstacked, 1 for [L,...],
    2 for hybrid [G,k,...])."""
    base = ndim - n_stack
    for pat, rank, dims in RULES:
        if rank == base and re.search(pat, path_str):
            return ("__stack__",) * n_stack + dims
    return (None,) * ndim


def _stack_depth(path_str: str, family: str) -> int:
    """Stacked prefix depth for a leaf under layers/encoder-layers."""
    if "layers/blocks" in path_str:          # hybrid [G, k, ...]
        return 1 if path_str.endswith("gates") else 2
    if re.search(r"(^|/)layers/", path_str):
        return 1
    return 0


def _trim(entries: list) -> Spec:
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


class AxisMap(dict):
    """logical name -> mesh axis (or axis tuple); missing => replicated."""

    def to_pspec(self, dims: Tuple[Optional[str], ...],
                 shape: Optional[Tuple[int, ...]] = None,
                 axis_sizes: Optional[Dict[str, int]] = None) -> Spec:
        """Divisibility-aware assignment.  Primary dims get their axis when
        the size divides; SECONDARY dims only fire when the tensor's primary
        dim failed, so each mesh axis is used at most once per tensor."""
        entries: list = [None] * len(dims)
        used: set = set()

        def axes_of(name):
            ax = self.get(name)
            if ax is None:
                return None, ()
            return ax, (ax if isinstance(ax, tuple) else (ax,))

        def divisible(i, ax_t):
            if shape is None or axis_sizes is None:
                return True
            size = 1
            for a in ax_t:
                size *= axis_sizes.get(a, 1)
            return size > 0 and shape[i] % size == 0

        for pass_secondary in (False, True):
            for i, d in enumerate(dims):
                if d is None or entries[i] is not None:
                    continue
                if (d in SECONDARY) != pass_secondary:
                    continue
                ax, ax_t = axes_of(d)
                if ax is None or any(a in used for a in ax_t):
                    continue
                if divisible(i, ax_t):
                    entries[i] = ax
                    used.update(ax_t)
        return _trim(entries)


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over nested dicts; ``path`` is the
    ``/``-joined key path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


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


def param_specs(params_or_shapes, axis_map: AxisMap, family: str,
                axis_sizes: Optional[Dict[str, int]] = None) -> Any:
    """Spec tree matching the parameter tree (leaves: anything with a
    ``shape``, e.g. tensors on the meta device)."""

    def spec_of(path, leaf):
        shape = tuple(leaf.shape)
        dims = logical_spec(path, len(shape),
                            n_stack=_stack_depth(path, family))
        return axis_map.to_pspec(dims, shape, axis_sizes)

    return tree_map_with_path(spec_of, params_or_shapes)


def largest_dim_spec(leaf, axes: Tuple[str, ...], axes_size: int) -> Spec:
    """ZeRO spec: shard the largest *divisible* dimension over ``axes``."""
    shape = tuple(leaf.shape)
    if not shape:
        return ()
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    for dim in dims:
        if shape[dim] % axes_size == 0 and shape[dim] >= axes_size:
            entries: list = [None] * len(shape)
            entries[dim] = axes if len(axes) > 1 else axes[0]
            return _trim(entries)
    return ()


def zero_specs(params_or_shapes, axes: Tuple[str, ...], axes_size: int):
    return tree_map_with_path(
        lambda _, leaf: largest_dim_spec(leaf, axes, axes_size),
        params_or_shapes)


def add_fsdp_axis(leaf, spec: Spec, axes: Tuple[str, ...],
                  axes_size: int) -> Spec:
    """FSDP: put the data axes on the largest still-unsharded divisible dim
    of an already (tensor-)sharded leaf."""
    shape = tuple(leaf.shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    free = [i for i in range(len(shape)) if entries[i] is None
            and shape[i] % axes_size == 0 and shape[i] >= axes_size]
    if not free:
        return spec
    dim = max(free, key=lambda i: shape[i])
    entries[dim] = axes if len(axes) > 1 else axes[0]
    return _trim(entries)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec uses, in the order of its dims."""
    out: list = []
    for e in spec:
        if e is not None:
            out.extend(e if isinstance(e, tuple) else (e,))
    return tuple(out)


# --------------------------------------------------------------------- #
# the mesh at run time
# --------------------------------------------------------------------- #

class Mesh:
    """Ranks of the world laid out over named axes, seen as the
    reference's mesh: ``axis_names`` and ``shape`` (axis -> size), so the
    plans' spec functions take it as they take a ``MeshSpec``; plus this
    rank's coordinate on each axis and one process group for every set
    of axes.

    ``grid`` holds ranks of the world, each at most once: every rank in
    row-major order for the flat plans, with permuted pod blocks for a
    pipeline's ``stage_order``, or the ranks a placement runs on (the
    reference's ``devices=``; the survivors of a failed site).  A rank
    outside the grid has no coordinate (``coord`` is None) and takes no
    step.  A group ranks its members by global rank
    (``torch.distributed.new_group``), which is their coordinate order,
    major axis first, the order in which a spec entry such as ``("pod",
    "data")`` splits a dim, so the grid keeps its ranks ascending along
    every axis but the stage axis, whose permuted order ``members``
    gives.  Every group is made here, by every rank of the world in the
    same order, outside ranks too, as ``torch.distributed`` requires.
    """

    def __init__(self, grid, axis_names):
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        grid = np.asarray(grid, dtype=np.int64)
        self.grid = grid
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        flat = np.sort(grid.ravel())
        if grid.ndim != len(self.axis_names) or not flat.size or \
                flat[0] < 0 or flat[-1] >= dist.get_world_size() or \
                np.any(flat[1:] == flat[:-1]):
            raise ValueError(f"the mesh must lay ranks of the world out at "
                             f"most once each, got {grid.tolist()}")
        for i, a in enumerate(self.axis_names):
            if a != "stage" and np.any(np.diff(grid, axis=i) <= 0):
                raise ValueError(f"the mesh's ranks must ascend along axis "
                                 f"{a!r}, got {grid.tolist()}")
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in flat)
        # the rank that writes and logs for the mesh
        self.first_rank: int = self.ranks[0]
        me = dist.get_rank()
        self.coord: Optional[Dict[str, int]] = \
            self.coord_of(me) if me in self.ranks else None
        self._groups: Dict[Tuple[str, ...], Any] = {}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for axes in itertools.combinations(self.axis_names, k):
                keep = [self.axis_names.index(a) for a in axes]
                rest = [i for i in range(n) if i not in keep]
                sub = np.transpose(grid, rest + keep).reshape(
                    -1, int(np.prod([grid.shape[i] for i in keep])))
                cur, _ = dist.new_subgroups_by_enumeration(sub.tolist())
                self._groups[axes] = cur

    @property
    def holds_me(self) -> bool:
        """Whether this rank is one of the mesh's."""
        return self.coord is not None

    def barrier(self) -> None:
        """Wait for every rank of the mesh (not of the world)."""
        dist.barrier(group=self._groups[self.axis_names])

    def coord_of(self, rank: int) -> Dict[str, int]:
        """A rank's coordinate on each axis."""
        at = np.argwhere(self.grid == rank)[0]
        return dict(zip(self.axis_names, (int(c) for c in at)))

    def members(self, axes) -> Tuple[int, ...]:
        """The ranks of this rank's group along ``axes``, in coordinate
        order (major axis first)."""
        axes = self._ordered(axes)
        index = tuple(slice(None) if a in axes else self.coord[a]
                      for a in self.axis_names)
        return tuple(int(r) for r in self.grid[index].ravel())

    def _ordered(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if list(axes) != sorted(axes, key=self.axis_names.index):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.axis_names}")
        return axes

    def group(self, axes):
        """Process group of this rank's ranks along ``axes``."""
        return self._groups[self._ordered(axes)]

    def count(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._ordered(axes)]))

    def index(self, axes) -> int:
        """This rank's position along ``axes``, major axis first."""
        i = 0
        for a in self._ordered(axes):
            i = i * self.shape[a] + self.coord[a]
        return i


# --------------------------------------------------------------------- #
# counted collectives
# --------------------------------------------------------------------- #

KINDS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast", "send",
         "recv")
_COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}
# the open collective trace's raw records, (kind, bytes, group or peer
# rank), or None (``launch.collective_trace.CollectiveTrace``)
_TRACE: Optional[list] = None


def reset_collective_counts() -> None:
    for rec in _COUNTS.values():
        rec["calls"] = rec["bytes"] = 0


def collective_counts() -> Dict[str, Dict[str, int]]:
    """Calls and bytes of each collective kind since the last reset; the
    bytes are those of the whole tensor a collective works over (the
    input of an all-reduce and a reduce-scatter, the output of an
    all-gather, the tensor a ``broadcast`` or a point-to-point ``send``
    or ``recv`` moves).
    A handoff within one rank is no send."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def _count(kind: str, t: torch.Tensor, factor: int = 1,
           group=None) -> None:
    n = t.numel() * t.element_size() * factor
    _COUNTS[kind]["calls"] += 1
    _COUNTS[kind]["bytes"] += n
    if _TRACE is not None:
        _TRACE.append((kind, n, group))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """All-reduce ``t`` in place over ``group``; returns ``t``."""
    _count("all_reduce", t, group=group)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Sum ``t`` over ``group`` and return this rank's block of ``dim``
    (the blocks stacked first: one copy, none along dim 0)."""
    n = dist.get_world_size(group)
    _count("reduce_scatter", t, group=group)
    blocks = t.contiguous() if dim == 0 else \
        torch.stack(t.chunk(n, dim)).flatten(0, 1)
    out = blocks.new_empty((blocks.shape[0] // n,) + blocks.shape[1:])
    dist.reduce_scatter_tensor(out, blocks, group=group)
    return out


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``t`` of ``group`` along ``dim``, in group
    rank order (gathered stacked, then one copy, none along dim 0)."""
    n = dist.get_world_size(group)
    _count("all_gather", t, n, group)
    x = t.contiguous()
    out = x.new_empty((n * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.view((n,) + x.shape).unbind(0), dim)


def broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every rank of ``group``, in
    place; returns ``t``."""
    _count("broadcast", t, group=group)
    dist.broadcast(t, src=src, group=group)
    return t


def exchange(sends, recvs) -> None:
    """One tick's point-to-point handoffs of a pipeline: ``sends`` and
    ``recvs`` are lists of (peer rank, tensor), the receive buffers
    filled in place.  They go in one ``batch_isend_irecv``, so a pair of
    ranks that send to each other in the same tick cannot deadlock."""
    ops = []
    for peer, t in sends:
        _count("send", t, group=peer)
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer))
    for peer, t in recvs:
        _count("recv", t, group=peer)
        ops.append(dist.P2POp(dist.irecv, t, peer))
    for req in dist.batch_isend_irecv(ops):
        req.wait()


# --------------------------------------------------------------------- #
# full leaves <-> this rank's slices
# --------------------------------------------------------------------- #

def _entry_axes(e) -> Tuple[str, ...]:
    return e if isinstance(e, tuple) else (e,)


def slice_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a full leaf (a copy where it is cut, the
    leaf itself where every axis of the spec has size 1)."""
    out = t
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n = mesh.count(_entry_axes(e))
        if n > 1:
            size = t.shape[dim] // n
            out = out.narrow(dim, mesh.index(_entry_axes(e)) * size, size)
    return out.clone() if out is not t else t


def gather_leaf(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full leaf from every rank's block (a collective over the
    spec's axes)."""
    for dim, e in enumerate(spec):
        if e is not None:
            t = all_gather(t, mesh.group(_entry_axes(e)), dim)
    return t


def shard_tree(tree, specs, mesh: Mesh):
    """Full leaves -> this rank's blocks, by the spec tree."""
    return tree_map_with_path(lambda _, t, s: slice_leaf(t, s, mesh),
                              tree, specs)


def gather_tree(tree, specs, mesh: Mesh):
    """This rank's blocks -> full leaves on every rank."""
    return tree_map_with_path(lambda _, t, s: gather_leaf(t, s, mesh),
                              tree, specs)


# --------------------------------------------------------------------- #
# tensor parallelism over the ``model`` axis: Megatron's f and g
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class ModelAxis:
    """What the layers need of the ``model`` mesh axis under a plan that
    shards weights: its process group, size and this rank's coordinate,
    and which kinds of leaf the plan's specs cut on it (a leaf whose dim
    does not divide stays whole, and its layer computes it whole on
    every rank).  The attention and MLP flags describe the dense blocks:
    the layers' own, or the hybrid family's shared block."""
    group: Any
    size: int
    rank: int
    vocab: bool      # embed/table (and lm_head/table) on the vocab dim
    positions: bool  # pos_embed/table on its rows (the reference's rules
    #                  match it as an embedding table)
    heads: bool      # wq, bq, wo on the heads dim
    kv_heads: bool   # wk, wv, bk, bv on the kv-heads dim
    mlp: bool        # the MLP's hidden dim
    experts: bool = False         # moe/w_gate, w_up, w_down on the experts
    shared_experts: bool = False  # moe/shared_* on their hidden dim
    d_inner: bool = False   # the SSM's channels: each rank runs a block
    #                         of them (and, for Mamba2, of whole heads)
    # the mamba leaves cut over the axis: (name, dim of a layer's leaf)
    ssm_cut: Tuple[Tuple[str, int], ...] = ()


class _CopyToModel(torch.autograd.Function):
    """f: identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial sums of the model axis added forward; identity
    backward (every rank's loss is the same number)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    return _ReduceFromModel.apply(x, axis.group)


# --------------------------------------------------------------------- #
# gather for use, reduce-scatter the gradient
# --------------------------------------------------------------------- #

class _GatherLeaves(torch.autograd.Function):
    """Forward: each leaf whole from the blocks of ``group`` along its
    own dim, all of them through one flat buffer (one all-gather).
    Backward: with ``scatter``, the gradients summed over ``group`` and
    cut back to this rank's blocks (one reduce-scatter); else summed over
    ``sum_group`` (None: not summed, every rank holds the whole
    gradient) and cut."""

    @staticmethod
    def forward(ctx, dims, group, scatter, sum_group, index, *blocks):
        n = dist.get_world_size(group)
        ctx.dims, ctx.group, ctx.scatter = dims, group, scatter
        ctx.sum_group, ctx.index, ctx.n = sum_group, index, n
        ctx.shapes = [b.shape for b in blocks]
        ctx.dtype, ctx.device = blocks[0].dtype, blocks[0].device
        flat = torch.cat([b.reshape(-1) for b in blocks])
        every = all_gather(flat, group, 0).view(n, -1)
        outs, at = [], 0
        for b, d in zip(blocks, dims):
            # the n blocks side by side along d (a view for one rank)
            part = every[:, at:at + b.numel()].reshape((n,) + b.shape)
            outs.append(part.movedim(0, d).reshape(
                b.shape[:d] + (n * b.shape[d],) + b.shape[d + 1:]))
            at += b.numel()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        rows = []
        for g, shape, d in zip(gs, ctx.shapes, ctx.dims):
            if g is None:                  # a leaf the use left unused
                rows.append(torch.zeros((n, shape.numel()), dtype=ctx.dtype,
                                        device=ctx.device))
                continue
            rows.append(g.reshape(shape[:d] + (n, shape[d]) + shape[d + 1:])
                        .movedim(d, 0).reshape(n, -1))
        flat = torch.cat(rows, 1)
        if ctx.scatter:
            mine = reduce_scatter(flat, ctx.group, 0)[0]
        else:
            if ctx.sum_group is not None:
                flat = all_reduce(flat, ctx.sum_group)
            mine = flat[ctx.index]
        out, at = [], 0
        for shape in ctx.shapes:
            out.append(mine[at:at + shape.numel()].view(shape))
            at += shape.numel()
        return (None,) * 5 + tuple(out)


def gather_for_use(t: torch.Tensor, dim: int, group, *, index: int,
                   scatter: bool = True, sum_group=None) -> torch.Tensor:
    """The whole leaf from this rank's block ``t`` (``index`` along the
    group); its gradient goes back to the block, summed over ``group``
    (``scatter``) or over ``sum_group``.  The summed gradient is the
    one ``all_reduce`` then ``slice_leaf`` give, as ``core.steps
    .PlanStep`` reduces a leaf that is not cut."""
    return _GatherLeaves.apply((dim,), group, scatter, sum_group, index,
                               t)[0]


def subtree(tree, path: str):
    """The node of nested dicts at a ``/``-joined ``path``."""
    for key in path.split("/") if path else ():
        tree = tree[key]
    return tree


class FsdpGather:
    """fsdp's gather for use: the leaves of a params subtree whose specs
    cut them over the data axes are gathered whole over those axes at
    their use, and their gradients reduce-scattered back onto the blocks,
    summed over the ranks that split the batch (``gather_for_use``, all
    of one call's leaves through one flat buffer: one all-gather and one
    reduce-scatter for a layer).
    ``Model`` calls it on each layer inside its layer loop (so a rank
    holds one layer whole at a time, and remat's recompute gathers
    again), and on the embedding, the position table, the final norm,
    the head and the hybrid's shared block at their use.

    ``__call__(path, tree, depth, upto)``: ``tree`` is the node at
    ``path`` with its first ``depth`` dims (the stack's) indexed away;
    the leaves whose data-axes cut lies on a dim in ``[depth, upto)`` of
    the full leaf are gathered.  A leaf cut on a stack dim is gathered
    whole before the loop (``upto`` the stack's depth)."""

    def __init__(self, specs, mesh: Mesh, axes: Tuple[str, ...],
                 batch_axes: Tuple[str, ...]):
        self.specs, self.mesh, self.axes = specs, mesh, tuple(axes)
        self.entry = self.axes if len(self.axes) > 1 else self.axes[0]
        self.group = mesh.group(self.axes)
        self.index = mesh.index(self.axes)
        # the gradient of a gathered leaf is partial over the batch axes
        self.scatter = all(a in batch_axes for a in self.axes)
        self.sum_group = mesh.group(batch_axes) \
            if batch_axes and not self.scatter else None

    def cut_dim(self, spec) -> Optional[int]:
        """The dim of a leaf's spec cut over the data axes, or None."""
        return next((d for d, e in enumerate(spec) if e == self.entry), None)

    def __call__(self, path: str, tree, depth: int = 0,
                 upto: Optional[int] = None):
        picked = []

        def pick(sub, t, spec):
            d = self.cut_dim(spec)
            if d is not None and d >= depth and (upto is None or d < upto):
                picked.append((sub, t, d - depth))
            return t

        tree_map_with_path(pick, tree, subtree(self.specs, path))
        if not picked:
            return tree
        whole = dict(zip((p for p, _, _ in picked), _GatherLeaves.apply(
            tuple(d for _, _, d in picked), self.group, self.scatter,
            self.sum_group, self.index, *(t for _, t, _ in picked))))
        return tree_map_with_path(lambda sub, t: whole.get(sub, t), tree)
