"""The paper's pretraining techniques as execution plans (port of
``repro/core/plans.py``), and ``Placement``, where a plan runs on an
N-site topology.

    Data      — pure data parallelism: params replicated, batch split,
                gradient all-reduce (paper §III-A).
    ZeRO2     — data parallelism with gradients + optimizer state sharded
                over the data axes: reduce-scatter grads, shard-local AdamW,
                all-gather updated params (paper §III-B, DeepSpeed ZeRO-2).
    Shard     — intra-operator parallelism: weights sharded on their
                logical axes over the ``model`` mesh axis, batch over the
                data axes (paper §III-B "Shard").
    Pipeshard — the layer stack cut into stages over a ``stage`` mesh axis,
                microbatches pipelined between them point to point, and
                the Shard rules inside each stage (``core.pipeline``).

A plan turns (params, mesh) into specs: which mesh axes cut each
parameter, optimizer-state leaf and batch leaf.  The spec methods read
only ``mesh.axis_names`` and ``mesh.shape``, so they take a device-free
``MeshSpec`` or the runtime ``core.sharding.Mesh`` alike, and give the
reference's ``PartitionSpec``s as tuples (on a staged ``("stage",
"data", "model")`` mesh too).  ``core.steps.build_train_step`` runs
every plan of ``PLANS`` on ``torch.distributed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sharding as shardlib
from repro_torch.core.sharding import AxisMap

# Mesh axis vocabulary: production meshes use ("pod",)? + ("data", "model");
# Pipeshard views reshape to ("stage", "data", "model").
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


@dataclass(frozen=True)
class MeshSpec:
    """Device-free stand-in for a mesh: axis names and sizes only.

    Every ``Plan`` spec method consults only ``mesh.axis_names`` and
    ``mesh.shape``, so the specs of any mesh come without a single
    device or process group.
    """
    axes: Tuple[Tuple[str, int], ...]

    @classmethod
    def of(cls, shape: Sequence[int],
           names: Sequence[str]) -> "MeshSpec":
        if len(shape) != len(names):
            raise ValueError(f"shape {tuple(shape)} vs axis names "
                             f"{tuple(names)}")
        return cls(tuple(zip(names, (int(n) for n in shape))))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n


def _one(axes: Tuple[str, ...]):
    """A spec entry for a dim split over ``axes`` (one or more)."""
    return axes if len(axes) > 1 else axes[0]


@dataclass(frozen=True)
class Plan:
    """A hardware-independent execution plan: how params, optimizer
    state, and the batch are sharded over a mesh, keyed by the paper's
    technique names (see ``PLANS`` / ``get_plan``).

    Attributes:
        name: plan name (``PLANS`` key).
        shards_weights: tensor parallelism over the ``model`` axis.
        zero_sharding: grads/opt-state sharded over the data axes.
        pipeline: stage axis + microbatch pipelining (Pipeshard).
        fsdp: params ALSO sharded over the data axes (ZeRO-3; beyond
            the paper).
    """
    name: str
    shards_weights: bool
    zero_sharding: bool
    pipeline: bool
    fsdp: bool = False

    # ------------------------------------------------------------- #
    def mesh_axes(self, mesh) -> Dict[str, Tuple[str, ...]]:
        names = mesh.axis_names
        data = tuple(a for a in names if a in DATA_AXES)
        model = tuple(a for a in names if a == MODEL_AXIS)
        stage = tuple(a for a in names if a == STAGE_AXIS)
        return {"data": data, "model": model, "stage": stage}

    def batch_axes(self, mesh, global_batch: int) -> Tuple[str, ...]:
        """Mesh axes the batch dim is split over, greedily folding in axes
        that still divide the batch.  Pure data parallelism also folds in
        the model axis — the paper's Data plan uses *all* GPUs as replicas
        when it can."""
        ax = self.mesh_axes(mesh)
        cand = ax["data"] if (self.shards_weights or self.pipeline) \
            else ax["data"] + ax["model"]
        axes, prod = [], 1
        for a in cand:
            n = mesh.shape[a]
            if global_batch > 0 and global_batch % (prod * n) == 0:
                axes.append(a)
                prod *= n
        return tuple(axes)

    # ------------------------------------------------------------- #
    def axis_map(self, mesh) -> AxisMap:
        """logical dim -> mesh axis mapping for parameters."""
        if not self.shards_weights and not self.pipeline:
            return AxisMap()                      # fully replicated params
        # NB deliberately NO head_dim/embed_d secondaries: sharding the
        # contraction dim of q/k or of the unembedding all-reduces every
        # attention score block / the full logits.  Non-divisible
        # heads/vocab fall back to replication instead.
        m = AxisMap(
            vocab=MODEL_AXIS, heads=MODEL_AXIS, kv_heads=MODEL_AXIS,
            mlp=MODEL_AXIS, expert=MODEL_AXIS, d_inner=MODEL_AXIS,
        )
        if self.pipeline:
            m["__stack__"] = STAGE_AXIS
        return m

    def _data_size(self, mesh) -> Tuple[Tuple[str, ...], int]:
        axes = self.mesh_axes(mesh)["data"]
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        return axes, size

    def param_specs(self, params_or_shapes, cfg: ModelConfig, mesh):
        specs = shardlib.param_specs(params_or_shapes, self.axis_map(mesh),
                                     cfg.family, dict(mesh.shape))
        if not self.fsdp:
            return specs
        axes, size = self._data_size(mesh)
        return shardlib.tree_map_with_path(
            lambda _, leaf, spec: shardlib.add_fsdp_axis(leaf, spec, axes,
                                                         size),
            params_or_shapes, specs)

    def opt_specs(self, params_or_shapes, cfg: ModelConfig, mesh):
        """Optimizer-state (and gradient reduce-scatter) specs.

        FSDP: optimizer state lives exactly on the param shards.  ZeRO2:
        params stay replicated/TP-sharded, m/v spread over the data axes
        on the largest divisible dim."""
        if self.fsdp or not self.zero_sharding:
            return self.param_specs(params_or_shapes, cfg, mesh)
        axes, size = self._data_size(mesh)
        return shardlib.zero_specs(params_or_shapes, axes, size)

    # ------------------------------------------------------------- #
    def batch_spec(self, batch, mesh) -> Any:
        """Input batch specs: batch dim over the plan's batch axes."""
        def leaf_spec(_, leaf):
            axes = self.batch_axes(mesh, leaf.shape[0])
            return (_one(axes),) if axes else ()
        return shardlib.tree_map_with_path(leaf_spec, batch)


@dataclass(frozen=True)
class Placement:
    """Where (and how) a plan runs on an N-site topology
    (core/topology.py).

    Produced by ``core.search.PlanSearch`` and handed to a prober
    (``core.selector``) or to ``launch.mesh.placement_mesh``.  See
    docs/topology-and-search.md.

    Attributes:
        sites: the participating site subset (topology site indices).
        stage_order: for pipeline plans, the stage→site assignment —
            stages follow this order, not the raw site numbering, so an
            asymmetric-link topology can be crossed in its cheapest order
            (DESIGN.md §5).  ``None`` means stages follow ``sites`` order
            (non-pipeline plans always leave it ``None``).
        stage_layers: for pipeline plans, per-stage layer counts from the
            TFLOP-weighted balancer (``core.costmodel
            .balanced_stage_layers``), in stage order.  ``None`` means the
            even split.  Under an interleaved schedule the entries are
            per virtual-stage *chunk* (``n_stages * v`` of them, chunk c
            running on stage ``c % n_stages``).
        schedule: for pipeline plans, the tick-order schedule the
            runtime executes and the cost model priced —
            ``core.costmodel.SCHEDULES`` (docs/schedules.md).
            Non-pipeline plans keep the ``"gpipe"`` default, which is
            ignored.
    """
    sites: Tuple[int, ...]
    stage_order: Optional[Tuple[int, ...]] = None
    stage_layers: Optional[Tuple[int, ...]] = None
    schedule: str = "gpipe"

    def __post_init__(self):
        from repro_torch.core.costmodel import parse_schedule
        _, v = parse_schedule(self.schedule)   # validates the name too
        if self.stage_order is not None and \
                sorted(self.stage_order) != sorted(self.sites):
            raise ValueError(
                f"stage_order {self.stage_order} is not a permutation "
                f"of sites {self.sites}")
        if self.stage_layers is not None:
            if len(self.stage_layers) != self.n_stages * v:
                raise ValueError(
                    f"stage_layers {self.stage_layers} has "
                    f"{len(self.stage_layers)} entries for "
                    f"{self.n_stages} stages x {v} virtual "
                    f"({self.schedule})")
            if any(l < 1 for l in self.stage_layers):
                raise ValueError(f"every stage needs >= 1 layer, got "
                                 f"{self.stage_layers}")

    @property
    def n_stages(self) -> int:
        """Number of pipeline stages (one per participating site)."""
        return len(self.stage_order or self.sites)

    def pod_permutation(self) -> Tuple[int, ...]:
        """Order of the mesh's pod blocks (one per site, in ``sites``
        order) realizing the stage order.

        Returns:
            Tuple ``p`` with ``p[k]`` = index into ``sites`` of the site
            that runs stage ``k``.
        """
        if self.stage_order is None:
            return tuple(range(len(self.sites)))
        pos = {s: k for k, s in enumerate(self.sites)}
        return tuple(pos[s] for s in self.stage_order)


PLANS: Dict[str, Plan] = {
    "data": Plan("data", shards_weights=False, zero_sharding=False,
                 pipeline=False),
    "zero2": Plan("zero2", shards_weights=False, zero_sharding=True,
                  pipeline=False),
    "shard": Plan("shard", shards_weights=True, zero_sharding=False,
                  pipeline=False),
    # zero-sharded optimizer states compose with tensor parallelism
    "shard_zero": Plan("shard_zero", shards_weights=True, zero_sharding=True,
                       pipeline=False),
    "pipeshard": Plan("pipeshard", shards_weights=True, zero_sharding=False,
                      pipeline=True),
    # beyond-paper: full FSDP/ZeRO-3 — params sharded over data axes too
    "fsdp": Plan("fsdp", shards_weights=True, zero_sharding=True,
                 pipeline=False, fsdp=True),
}


def get_plan(name: str) -> Plan:
    """Look up an execution plan by technique name.

    Raises:
        KeyError: unknown plan name (message lists the options).
    """
    try:
        return PLANS[name]
    except KeyError:
        raise KeyError(f"unknown plan {name!r}; available {sorted(PLANS)}") \
            from None
