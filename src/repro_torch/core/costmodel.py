"""α–β analytical cost model of the paper's FABRIC GPU clusters.

Reproduces the paper's Figures 3–7 and Table II: per-technique pretraining
time for GPT-2 medium/large on two-VM slices with measured site-to-site
latencies.  The model is deliberately simple — compute term from achievable
per-GPU FLOP/s, communication terms from per-step traffic of each technique
over the cluster's link graph with latency α and bandwidth β — because the
*paper's claims are about orderings and trends*, which is what
EXPERIMENTS.md §Paper-validation checks.

Since the N-site generalization (core/topology.py, DESIGN.md §5) the
pricing works on an arbitrary ``Topology``: collectives pay the worst link
on their spanning set, Pipeshard pays each stage-boundary link it actually
crosses in its stage→site order.  The legacy two-VM ``Cluster`` is kept as
a thin shim whose ``topology()`` is the N=2 special case, so every paper
artifact (PAPER_CLUSTERS, benchmarks, Algorithm 1) keeps its exact shape
and numbers.

Per-technique pricing is a registry of composable cost components
(``TECHNIQUE_SPECS``, docs/cost-model.md): each ``TechniqueSpec``
assembles compute, collective, p2p (with a ``carrier_dtype`` byte
knob), and memory (explicit ``MemoryModel`` replication fractions)
terms over a shared ``CostContext``.  The paper's four specs price
bit-for-bit what the pre-registry chain did; the beyond-paper
``shard_zero`` and ``fsdp`` specs make every plan ``core.plans.PLANS``
executes also *recommendable* by the search.

The same machinery prices TPU meshes (ICI vs DCN) for plan selection when
no hardware is attached — the dry-run roofline (launch/roofline.py) uses
compiled HLO instead wherever it can.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topology import (GPUS, GPUSpec, Link, PCIE, Site,
                                       TCP_WINDOW_BYTES, Topology, two_site)

# Legacy alias: the paper called a site a "VM".
VM = Site


@dataclass(frozen=True)
class Cluster:
    """Two-VM FABRIC slice (paper Table I) — legacy N=2 shim over
    ``core.topology.Topology``."""
    name: str
    vms: Tuple[Site, ...]
    wan: Link                              # inter-VM (L2Bridge / L2STS)

    def all_gpus(self) -> List[GPUSpec]:
        return [GPUS[g] for vm in self.vms for g in vm.gpus]

    def topology(self) -> Topology:
        """Embed as the N=2 special case of the site/link graph."""
        import itertools
        sites = tuple(
            Site(vm.gpus, vm.intra, vm.name or f"V{i + 1}")
            for i, vm in enumerate(self.vms))
        links = {(i, j): self.wan
                 for i, j in itertools.combinations(range(len(sites)), 2)}
        return Topology(self.name, sites, links)


ClusterLike = Union[Cluster, Topology]


def as_topology(cluster: ClusterLike) -> Topology:
    return cluster.topology() if isinstance(cluster, Cluster) else cluster


def fabric_cluster(name: str, gpus1: Tuple[str, str], gpus2: Tuple[str, str],
                   latency_ms: float, wan_gbps: float = 3.0) -> Cluster:
    """WAN bandwidth: NCCL over TCP/IP on FABRIC achieves only a few GB/s
    of the 100 Gbps links (paper §II-C: TCP/IP, no GPUDirect)."""
    return Cluster(name, (Site(tuple(gpus1)), Site(tuple(gpus2))),
                   Link(latency_ms * 1e-3, wan_gbps))


# The paper's five slices (Table I).
PAPER_CLUSTERS: Dict[str, Cluster] = {
    "TACC-TACC": fabric_cluster("TACC-TACC", ("RTX", "RTX"), ("T4", "T4"), 0.1),
    "UTAH-GPN": fabric_cluster("UTAH-GPN", ("RTX", "RTX"), ("T4", "T4"), 20.2),
    "UTAH-MASS": fabric_cluster("UTAH-MASS", ("RTX", "RTX"), ("RTX", "RTX"), 57.4),
    "BRIS-STAR": fabric_cluster("BRIS-STAR", ("A30", "A30"), ("RTX", "RTX"), 95.9),
    "GAT-AMST": fabric_cluster("GAT-AMST", ("A30", "A30"), ("A30", "A30"), 103.0),
}

# The same slices as 2-site topologies (what PlanSearch consumes).
PAPER_TOPOLOGIES: Dict[str, Topology] = {
    name: c.topology() for name, c in PAPER_CLUSTERS.items()
}


# --------------------------------------------------------------------- #
# workload description
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Workload:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    steps_per_epoch: int
    epochs: int = 20                      # the paper runs 20 epochs
    microbatches: int = 4

    @property
    def tokens_per_step(self) -> int:
        return self.seq_len * self.global_batch

    @property
    def flops_per_step(self) -> float:
        return 6.0 * self.cfg.active_param_count() * self.tokens_per_step

    def bytes_params(self) -> float:
        return 2.0 * self.cfg.param_count()          # fp16/bf16 on the wire

    def bytes_grads(self) -> float:
        return 2.0 * self.cfg.param_count()

    # Alpa's gpt-2 training keeps fp32 master params + fp32 Adam moments:
    def bytes_train_state(self) -> float:           # p+g+m+v, fp32
        return 16.0 * self.cfg.param_count()

    ACT_FACTOR = 10.0  # no-remat Alpa training: activations + attn scores
    OVERHEAD_GB = 2.0  # CUDA context, NCCL buffers, framework workspace

    def activation_bytes_per_gpu(self, n_gpus: int) -> float:
        c = self.cfg
        per_layer = self.tokens_per_step // max(n_gpus, 1) * c.d_model * 2
        return per_layer * c.n_layers * self.ACT_FACTOR


# the paper pretrains on 20231101.ace (~8MB dump): roughly 2M tokens
def paper_workload(cfg: ModelConfig, *, global_batch: int = 32) -> Workload:
    tokens = 2_000_000
    steps = max(1, tokens // (cfg.max_seq_len * global_batch))
    return Workload(cfg, cfg.max_seq_len, global_batch, steps)


# --------------------------------------------------------------------- #
# per-technique cost
# --------------------------------------------------------------------- #

LOG2E = 1.4426950408889634

# The paper's four techniques — Algorithm 1's pool, and the default
# everywhere a technique tuple is expected (paper artifacts keep their
# exact numbers).  ``ALL_TECHNIQUES`` (defined with the registry below)
# appends the beyond-paper ``shard_zero`` and ``fsdp`` specs the search
# can opt into.
TECHNIQUES = ("data", "zero2", "shard", "pipeshard")

# Inter-stage activation carrier dtypes the Pipeshard p2p term can be
# priced at.  "fp32" is the legacy baseline (the XLA-CPU-safe default of
# ``core.pipeline.make_pipeline_loss``); "bf16" halves the wire bytes —
# the real-accelerator carrier the runtime supports (docs/cost-model.md).
CARRIER_DTYPES = ("fp32", "bf16")

_CARRIER_SCALE = {"fp32": 1.0, "bf16": 0.5}


def carrier_scale(carrier_dtype: str) -> float:
    """Byte multiplier of an inter-stage carrier dtype vs the fp32
    baseline (``1.0`` for fp32, ``0.5`` for bf16).

    Raises:
        ValueError: unknown carrier dtype.
    """
    try:
        return _CARRIER_SCALE[carrier_dtype]
    except KeyError:
        raise ValueError(f"unknown carrier_dtype {carrier_dtype!r}; "
                         f"expected one of {CARRIER_DTYPES}") from None


# Wire dtypes generalize the p2p-only carrier axis to *collective*
# traffic as well (docs/quantization.md): the quantizable share of each
# technique's collective volume (``CommPrecision``) plus the pipeline
# boundary carriers ride the wire dtype; the rest stays fp32.  int8's
# scale is not 0.25: the per-128-block absmax scale of the kernels'
# scheme (kernels/quantized.py) travels too — (128·1 + 4) bytes per 128
# elements over the 128·4-byte fp32 baseline = 0.2578125.
WIRE_DTYPES = ("fp32", "bf16", "int8")

_WIRE_SCALE = {"fp32": 1.0, "bf16": 0.5, "int8": (128 + 4) / (128 * 4)}


def wire_scale(wire_dtype: str) -> float:
    """Byte multiplier of a wire dtype vs the fp32 baseline (1.0 fp32,
    0.5 bf16, 0.2578125 int8 — payload + per-block absmax scales).

    Raises:
        ValueError: unknown wire dtype.
    """
    try:
        return _WIRE_SCALE[wire_dtype]
    except KeyError:
        raise ValueError(f"unknown wire_dtype {wire_dtype!r}; "
                         f"expected one of {WIRE_DTYPES}") from None


@dataclass(frozen=True)
class CommPrecision:
    """Wire-quantizable fractions of a technique's collective volume
    (``TechniqueSpec.comm_precision``, docs/quantization.md).

    Attributes:
        act: fraction of *activation* collective volume (tensor-parallel
            all-reduces, stage-boundary traffic) that may ride the wire
            dtype.
        state: fraction of *gradient/optimizer-state* collective volume
            (DP all-reduce, ZeRO partition sync, FSDP gathers) that may
            ride the wire dtype.  The remaining ``1 - state`` is the
            fp32-master-weights correction term — partitioned fp32
            master syncs and reductions landing in fp32 shards cross the
            wire at full width whatever the wire dtype.
    """
    act: float = 1.0
    state: float = 1.0


def _eff_byte_scale(frac: float, ws: float) -> float:
    """Effective byte multiplier of a collective whose quantizable
    fraction is ``frac`` at wire scale ``ws``.  Exactly 1.0 at fp32 so
    legacy prices stay bit-for-bit (``frac*1 + (1-frac)`` may not)."""
    return 1.0 if ws == 1.0 else frac * ws + (1.0 - frac)


def _act_byte_scale(ctx: "CostContext") -> float:
    return _eff_byte_scale(ctx.comm.act, ctx.wire_scale)


def _state_byte_scale(ctx: "CostContext") -> float:
    return _eff_byte_scale(ctx.comm.state, ctx.wire_scale)

# Pipeline tick-order schedules (docs/schedules.md).  "gpipe" is the
# paper's measured Alpa behavior (all forwards, then all backwards —
# bubble (S-1)/m, m microbatches in flight); "1f1b" is PipeDream-Flush
# (same bubble, but a stage never holds more than S in-flight
# microbatches); "interleaved" is the Megatron-LM interleaved 1F1B
# schedule with v virtual stages (layer chunks) per device — bubble
# shrinks to (S-1)/(v*m) at the price of v crossings of every stage
# boundary.  "interleaved" defaults to v=2; "interleaved<k>" (e.g.
# "interleaved4") sets v explicitly.
SCHEDULES = ("gpipe", "1f1b", "interleaved")

DEFAULT_INTERLEAVE = 2


def parse_schedule(schedule: str) -> Tuple[str, int]:
    """Split a schedule name into (kind, virtual stages per device).

    Args:
        schedule: ``"gpipe"``, ``"1f1b"``, ``"interleaved"`` (v=2), or
            ``"interleaved<v>"`` with an explicit v >= 2 (e.g.
            ``"interleaved4"``).

    Returns:
        ``(kind, v)`` with ``kind`` in ``SCHEDULES`` and ``v == 1``
        except for interleaved schedules.

    Raises:
        ValueError: unknown schedule name or v < 2 on interleaved.
    """
    if schedule in ("gpipe", "1f1b"):
        return schedule, 1
    if schedule == "interleaved":
        return "interleaved", DEFAULT_INTERLEAVE
    if schedule.startswith("interleaved"):
        try:
            v = int(schedule[len("interleaved"):])
        except ValueError:
            raise ValueError(f"unknown schedule {schedule!r}; expected one "
                             f"of {SCHEDULES} or 'interleaved<v>'") from None
        if v < 2:
            raise ValueError(f"interleaved needs >= 2 virtual stages, "
                             f"got {schedule!r}")
        return "interleaved", v
    raise ValueError(f"unknown schedule {schedule!r}; expected one of "
                     f"{SCHEDULES} or 'interleaved<v>'")


def pipeline_bubble_fraction(schedule: str, n_stages: int,
                             n_micro: int) -> float:
    """Idle fraction of the pipeline, relative to ideal compute time.

    GPipe and 1F1B both pay ``(S-1)/m`` — 1F1B reorders backwards
    between forwards but drains the same warm-up/flush ramps.  The
    interleaved schedule cuts the ramp by its v virtual stages:
    ``(S-1)/(v*m)`` (Narayanan et al. 2021).

    Args:
        schedule: schedule name (see ``parse_schedule``).
        n_stages: pipeline stages S (devices/meshes in the ring).
        n_micro: microbatches m per optimizer step.

    Returns:
        The bubble fraction b, so step compute time scales as (1 + b).
    """
    kind, v = parse_schedule(schedule)
    bubble = (n_stages - 1) / n_micro
    return bubble / v if kind == "interleaved" else bubble


def pipeline_inflight_microbatches(schedule: str, n_stages: int,
                                   n_micro: int) -> float:
    """Microbatches of activations a stage holds at the schedule's peak.

    GPipe stashes every forward before the first backward: m in flight.
    1F1B starts backwards as soon as the pipeline fills, so a stage
    never holds more than ``min(S, m)``.  The interleaved schedule
    keeps 1F1B's bound but holds partially-processed chunks of the
    next wave: ``min(S, m) * (1 + (S-1)/(S*v))`` (Narayanan et al.
    2021) — slightly above 1F1B, still far below GPipe at large m.

    Args:
        schedule: schedule name (see ``parse_schedule``).
        n_stages: pipeline stages S.
        n_micro: microbatches m per optimizer step.

    Returns:
        Effective in-flight microbatch count (fractional for
        interleaved), monotone non-decreasing in m for every schedule.
    """
    kind, v = parse_schedule(schedule)
    if kind == "gpipe":
        return float(n_micro)
    inflight = float(min(n_stages, n_micro))
    if kind == "1f1b":
        return inflight
    return inflight * (1.0 + (n_stages - 1) / (n_stages * v))

# Pipeline stage-size policies: "even" reproduces the paper's measured
# Alpa behavior (equal meshes -> equal layer slices, what Table II and
# Algorithm 1 were run with); "tflops" weights stage sizes by per-site
# compute so a T4 site gets fewer layers than an A30 site (ROADMAP
# "heterogeneous stage balancing", docs/topology-and-search.md).
STAGE_BALANCE_MODES = ("even", "tflops")


def stage_compute_tflops(topo: Topology, order: Sequence[int],
                         calibration=None) -> List[float]:
    """Achievable TFLOP/s of each pipeline stage's site, in stage order.

    Args:
        topo: the topology the stages are placed on.
        order: site index per stage (a ``Placement.stage_order`` or plain
            site subset).
        calibration: optional measured-rate overlay
            (``calib.overlay.Calibration``); sites it covers use
            the achieved rate instead of the datasheet one.

    Returns:
        One entry per stage: the site's GPU count times its slowest GPU's
        achievable TFLOP/s (meshes are paced by their slowest member).
    """
    if calibration is None:
        return [min(GPUS[g].tflops for g in topo.sites[i].gpus)
                * len(topo.sites[i].gpus) for i in order]
    return [calibration.gpu_tflops(topo, i) * len(topo.sites[i].gpus)
            for i in order]


def balanced_stage_layers(n_layers: int, stage_tflops: Sequence[float]
                          ) -> Tuple[int, ...]:
    """Split ``n_layers`` across stages proportionally to stage TFLOP/s.

    Largest-remainder allocation with one layer reserved per stage, so the
    result always sums to ``n_layers``, every stage gets >= 1 layer, and a
    faster stage never gets fewer layers than a slower one.  Homogeneous
    stages degrade to the even split.

    Args:
        n_layers: total layers to distribute (>= number of stages).
        stage_tflops: per-stage achievable TFLOP/s (all > 0).

    Returns:
        Per-stage layer counts, in stage order.
    """
    k = len(stage_tflops)
    if k < 1:
        raise ValueError("need at least one stage")
    if n_layers < k:
        raise ValueError(f"cannot fill {k} stages with {n_layers} layers")
    if min(stage_tflops) <= 0:
        raise ValueError(f"non-positive stage TFLOP/s in {stage_tflops}")
    total = float(sum(stage_tflops))
    spare = n_layers - k
    quotas = [spare * t / total for t in stage_tflops]
    layers = [1 + int(q) for q in quotas]
    # leftover goes to the largest fractional parts (ties: earliest stage)
    order = sorted(range(k), key=lambda i: (-(quotas[i] - int(quotas[i])), i))
    for i in order[:n_layers - sum(layers)]:
        layers[i] += 1
    return tuple(layers)


@dataclass
class StepCost:
    compute_s: float
    comm_s: float
    mem_required_gb: float
    mem_available_gb: float

    @property
    def total_s(self) -> float:
        return self.compute_s + self.comm_s

    @property
    def fits(self) -> bool:
        return self.mem_required_gb <= self.mem_available_gb


def _allreduce_time(bytes_total: float, n: int, link: Link) -> float:
    """Ring all-reduce: 2(n-1)/n × bytes over the slowest link, with 2(n-1)
    latency hops, at the TCP-effective bandwidth."""
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * link.latency_s \
        + 2 * (n - 1) / n * bytes_total / (link.effective_gbps * 1e9)


def _gather_time(bytes_total: float, n: int, link: Link) -> float:
    """Ring all-gather or reduce-scatter: exactly half an all-reduce —
    (n-1) latency hops and (n-1)/n × bytes (an all-reduce IS a
    reduce-scatter followed by an all-gather)."""
    if n <= 1:
        return 0.0
    return (n - 1) * link.latency_s \
        + (n - 1) / n * bytes_total / (link.effective_gbps * 1e9)


# ---- calibrated lookups (calib.overlay, docs/calibration.md) ---------- #
#
# ``cal`` is a ``repro_torch.calib.overlay.Calibration``, duck-typed here so
# the core never imports the calib package: it must provide
# ``gpu_tflops(topo, i)``, ``link(topo, i, j)`` and
# ``spanning_links(topo, sites)``.  ``cal=None`` — and the identity
# overlay, whose lookups fall through to the very same objects and
# expressions — price bit-for-bit the analytic model (the differential
# gate in tests/test_calib_gates.py pins this with ``==``).

def _cal_intra(cal, topo: Topology, i: int) -> Link:
    return topo.sites[i].intra if cal is None else cal.link(topo, i, i)


def _cal_link(cal, topo: Topology, i: int, j: int) -> Link:
    return topo.link(i, j) if cal is None else cal.link(topo, i, j)


def _cal_spanning(cal, topo: Topology, sites: Sequence[int]) -> List[Link]:
    return topo.spanning_links(sites) if cal is None \
        else cal.spanning_links(topo, sites)


def _collective_time(bytes_total: float, n: int, topo: Topology,
                     sites: Sequence[int], cal=None) -> float:
    """All-reduce over a site subset: the ring crosses every site pair's
    path, so the *worst* spanning link prices the collective (the N=2
    special case is exactly the old single-``wan``-field rule)."""
    if len(sites) <= 1:
        return _allreduce_time(bytes_total, n,
                               _cal_intra(cal, topo, sites[0]))
    return max(_allreduce_time(bytes_total, n, l)
               for l in _cal_spanning(cal, topo, sites))


def _gather_collective_time(bytes_total: float, n: int, topo: Topology,
                            sites: Sequence[int], cal=None) -> float:
    """All-gather / reduce-scatter over a site subset, priced like
    ``_collective_time`` on the worst spanning link."""
    if len(sites) <= 1:
        return _gather_time(bytes_total, n, _cal_intra(cal, topo, sites[0]))
    return max(_gather_time(bytes_total, n, l)
               for l in _cal_spanning(cal, topo, sites))


# --------------------------------------------------------------------- #
# the technique cost registry (docs/cost-model.md)
#
# ``technique_step_cost`` used to be a four-way if/elif chain; it is now
# a dispatch over ``TECHNIQUE_SPECS`` — one ``TechniqueSpec`` per
# technique, built from four composable cost components sharing a
# ``CostContext``:
#
#   compute    pace-setter seconds (+ pipeline bubble)
#   collective per-collective volume terms on the worst spanning link
#   p2p        per-boundary microbatch carriers (pipeline only), scaled
#              by the carrier dtype
#   memory     params/grads/optimizer-state replication expressed as
#              explicit per-technique ``MemoryModel`` fractions
#
# The four paper specs price bit-for-bit what the legacy chain did
# (property-tested in tests/test_costmodel.py); ``shard_zero`` and
# ``fsdp`` are the beyond-paper specs that make the search able to
# recommend every plan ``core.plans.PLANS`` can execute.
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class _PipelineGeometry:
    """Derived pipeline quantities shared by the pipeshard components:
    validated stage order, schedule kind, per-chunk layer split, and the
    per-stage compute pool."""
    order: Tuple[int, ...]
    n_stages: int
    kind: str
    virt: int
    n_chunks: int
    stage_sites: Tuple[Site, ...]
    mesh_tflops: Tuple[float, ...]
    bubble: float
    split: Optional[Tuple[int, ...]]      # None = legacy even split
    stage_l: Optional[Tuple[int, ...]]    # per-stage layer totals


@dataclass
class CostContext:
    """Everything a cost component may look at for one
    (workload × placement) pricing.

    Attributes:
        wl: the workload being priced.
        topo: the N-site topology.
        sel: participating site indices.
        sites: the participating ``Site`` objects, in ``sel`` order.
        n: GPU pool size.
        tp: intra-site tensor-parallel degree available to hybrid
            techniques — the *smallest* participating site's GPU count
            (worst case for both memory and collective volume).
        flops: model FLOPs of one step.
        slowest: the pace-setting GPU's FLOP/s.
        g_bytes / p_bytes / state: gradient, bf16-param, and fp32 train
            state (p+g+m+v) bytes of the model.
        act: activation bytes per GPU at this pool size.
        ovh: fixed framework overhead GB.
        mem_avail: smallest participating GPU's memory in GB.
        stage_order / stage_balance / stage_layers / schedule: the
            Pipeshard placement knobs (ignored by flat-pool components).
        carrier_scale: byte multiplier of the inter-stage carrier dtype
            (``carrier_scale()``; 1.0 = legacy fp32 baseline).  When a
            sub-fp32 ``wire_dtype`` is active the narrower of the two
            prices the p2p carriers.
        wire_scale: byte multiplier of the collective wire dtype
            (``wire_scale()``; 1.0 = legacy fp32 baseline).
        comm: the priced technique's ``CommPrecision`` — which fractions
            of its collective volume may ride the wire dtype.
        cal: optional measured-rate ``Calibration`` overlay
            (``calib.overlay``); None and the identity overlay
            price bit-for-bit the analytic model.
    """
    wl: Workload
    topo: Topology
    sel: Tuple[int, ...]
    sites: List[Site]
    n: int
    tp: int
    flops: float
    slowest: float
    g_bytes: float
    p_bytes: float
    state: float
    act: float
    ovh: float
    mem_avail: float
    stage_order: Optional[Sequence[int]] = None
    stage_balance: str = "even"
    stage_layers: Optional[Sequence[int]] = None
    schedule: str = "gpipe"
    carrier_scale: float = 1.0
    wire_scale: float = 1.0
    comm: CommPrecision = field(default_factory=CommPrecision)
    cal: Optional[object] = None
    _geom: Optional[_PipelineGeometry] = field(default=None, repr=False)

    @property
    def act_stream_bytes(self) -> float:
        """Bytes of one full activation tensor crossing the network
        (the per-layer intra-op all-reduce payload and the Pipeshard
        stage-boundary carrier, before any carrier-dtype scaling)."""
        return self.wl.tokens_per_step * self.wl.cfg.d_model * 2

    def pipeline(self) -> _PipelineGeometry:
        """Validate + derive the pipeline geometry (cached).  Raises the
        same errors the legacy chain did: bad stage orders, splits that
        do not partition the stack, unknown balance modes."""
        if self._geom is not None:
            return self._geom
        wl, topo, sel = self.wl, self.topo, self.sel
        order = sel if self.stage_order is None \
            else topo.select(self.stage_order)
        if sorted(order) != sorted(sel):
            raise ValueError(
                f"stage_order {order} is not a permutation of sites {sel}")
        n_stages = max(len(order), 1)
        kind, virt = parse_schedule(self.schedule)
        n_chunks = n_stages * virt
        stage_sites = tuple(topo.sites[i] for i in order)
        stage_tf = stage_compute_tflops(topo, order, self.cal)
        mesh_tflops = tuple(t * 1e12 for t in stage_tf)
        bubble = pipeline_bubble_fraction(self.schedule, n_stages,
                                          wl.microbatches)
        if self.stage_layers is not None:
            split: Optional[Tuple[int, ...]] = tuple(self.stage_layers)
            if len(split) != n_chunks or min(split, default=0) < 1 \
                    or sum(split) != wl.cfg.n_layers:
                raise ValueError(
                    f"stage_layers {split} does not partition "
                    f"{wl.cfg.n_layers} layers into {n_chunks} "
                    f"{self.schedule} chunks")
        elif self.stage_balance == "tflops":
            # interleaved: chunk c runs on stage c % n_stages, so its
            # quota follows that stage's compute
            split = balanced_stage_layers(
                wl.cfg.n_layers,
                [stage_tf[c % n_stages] for c in range(n_chunks)])
        elif self.stage_balance == "even":
            split = None        # legacy continuous flops/n_stages split
        else:
            raise ValueError(f"stage_balance {self.stage_balance!r} not "
                             f"in {STAGE_BALANCE_MODES}")
        if split is None:
            stage_l = None
        else:
            # per-stage layer totals (a stage owns every chunk with
            # c % n_stages == its index; v == 1 degrades to the split)
            stage_l = tuple(sum(split[c] for c in range(n_chunks)
                                if c % n_stages == s)
                            for s in range(n_stages))
        self._geom = _PipelineGeometry(
            tuple(order), n_stages, kind, virt, n_chunks, stage_sites,
            mesh_tflops, bubble, split, stage_l)
        return self._geom


def _make_context(wl: Workload, cluster: ClusterLike,
                  vms: Optional[Sequence[int]], *,
                  stage_order: Optional[Sequence[int]] = None,
                  stage_balance: str = "even",
                  stage_layers: Optional[Sequence[int]] = None,
                  schedule: str = "gpipe",
                  carrier_dtype: str = "fp32",
                  wire_dtype: str = "fp32",
                  comm: Optional[CommPrecision] = None,
                  calibration=None) -> CostContext:
    topo = as_topology(cluster)
    sel = topo.select(vms)
    sites = [topo.sites[i] for i in sel]
    gpus = [GPUS[g] for s in sites for g in s.gpus]
    n = len(gpus)
    ws = wire_scale(wire_dtype)
    cs = carrier_scale(carrier_dtype)
    if ws != 1.0:
        # stage-boundary activations are wire-quantizable (pipeshard's
        # CommPrecision.act == 1.0) — the narrower dtype carries them
        cs = min(cs, ws)
    if calibration is None:
        slowest = min(g.tflops for g in gpus) * 1e12
    else:
        # pool pace = the slowest site's achieved per-GPU rate; with no
        # overrides each per-site min is over the same datasheet floats,
        # so min-of-mins is bit-for-bit the flat min above
        slowest = min(calibration.gpu_tflops(topo, i) for i in sel) * 1e12
    return CostContext(
        wl=wl, topo=topo, sel=sel, sites=sites, n=n,
        tp=min(len(s.gpus) for s in sites),
        flops=wl.flops_per_step,
        slowest=slowest,
        g_bytes=wl.bytes_grads(),
        p_bytes=wl.bytes_params(),
        state=wl.bytes_train_state(),       # fp32 p+g+m+v (Alpa default)
        act=wl.activation_bytes_per_gpu(n),
        ovh=wl.OVERHEAD_GB,
        mem_avail=min(g.mem_gb for g in gpus),
        stage_order=stage_order, stage_balance=stage_balance,
        stage_layers=stage_layers, schedule=schedule,
        carrier_scale=cs, wire_scale=ws,
        comm=comm if comm is not None else CommPrecision(),
        cal=calibration)


# ---- compute components --------------------------------------------- #

def _pool_compute(ctx: CostContext) -> float:
    """Flat data-parallel pool: the slowest GPU paces everyone."""
    return ctx.flops / (ctx.n * ctx.slowest)


def _pipeline_compute(ctx: CostContext) -> float:
    """The slowest (layer-weighted) stage paces every tick, inflated by
    the schedule's bubble fraction."""
    g = ctx.pipeline()
    if g.split is None:
        return max(ctx.flops / g.n_stages / t for t in g.mesh_tflops) \
            * (1 + g.bubble)
    return max(li / ctx.wl.cfg.n_layers * ctx.flops / t
               for li, t in zip(g.stage_l, g.mesh_tflops)) \
        * (1 + g.bubble)


# ---- collective components ------------------------------------------ #

def _data_collective(ctx: CostContext) -> float:
    """One gradient all-reduce over the whole pool.  Fully
    wire-quantizable (each rank's optimizer consumes the reduced grads
    locally), so the byte volume scales with ``_state_byte_scale`` —
    exactly the legacy bytes at fp32."""
    return _collective_time(ctx.g_bytes * _state_byte_scale(ctx),
                            ctx.n, ctx.topo, ctx.sel, ctx.cal)


def _zero2_collective(ctx: CostContext) -> float:
    """Reduce-scatter grads + all-gather of updated fp16 params + the
    partitioned fp32 master sync => ~2.2x the Data volume, which is the
    paper's observed zero2-vs-data degradation ratio (Table II).  Of the
    2.2, the 0.2 master-sync share is the fp32 correction term
    (``CommPrecision.state = 2.0/2.2``); the grad scatter + param gather
    ride the wire dtype."""
    return 2.2 * _collective_time(ctx.g_bytes * _state_byte_scale(ctx),
                                  ctx.n, ctx.topo, ctx.sel, ctx.cal)


def _intraop_collective(ctx: CostContext) -> float:
    """Megatron-style: 4 all-reduces of activations per layer (fwd+bwd)
    over the whole pool."""
    return 4 * ctx.wl.cfg.n_layers * _collective_time(
        ctx.act_stream_bytes * _act_byte_scale(ctx), ctx.n, ctx.topo,
        ctx.sel, ctx.cal)


def _pipeline_collective(ctx: CostContext) -> float:
    """Intra-op all-reduces inside each stage's site, over its own intra
    link, weighted by the stage's layer share; the slowest stage paces."""
    g = ctx.pipeline()
    act_bytes = ctx.act_stream_bytes * _act_byte_scale(ctx)
    if g.split is None:       # keep the legacy expression bit-for-bit
        return max(
            4 * ctx.wl.cfg.n_layers / g.n_stages * _allreduce_time(
                act_bytes, len(s.gpus), _cal_intra(ctx.cal, ctx.topo, i))
            for i, s in zip(g.order, g.stage_sites))
    return max(
        4 * li * _allreduce_time(act_bytes, len(s.gpus),
                                 _cal_intra(ctx.cal, ctx.topo, i))
        for li, i, s in zip(g.stage_l, g.order, g.stage_sites))


def _shard_zero_collective(ctx: CostContext) -> float:
    """Hybrid intra-op × ZeRO-2: Megatron all-reduces stay *inside* each
    site (one tensor-parallel group per site over its intra link, each
    site a data-parallel replica handling 1/n_sites of the batch), plus
    the ZeRO-2 partition sync across the site replicas — the 2.2x-factor
    collective of ``zero2`` at 1/tp the volume (grads are already
    TP-sharded)."""
    n_rep = len(ctx.sel)
    share = ctx.act_stream_bytes * _act_byte_scale(ctx) / n_rep
    intra = max(4 * ctx.wl.cfg.n_layers
                * _allreduce_time(share, len(s.gpus),
                                  _cal_intra(ctx.cal, ctx.topo, i))
                for i, s in zip(ctx.sel, ctx.sites))
    inter = 2.2 * _collective_time(
        ctx.g_bytes * _state_byte_scale(ctx) / ctx.tp, n_rep,
        ctx.topo, ctx.sel, ctx.cal)
    return intra + inter


def _fsdp_collective(ctx: CostContext) -> float:
    """ZeRO-3: every layer's params are all-gathered before its forward
    AND again before its backward (nothing is kept), and grads are
    reduce-scattered straight into the shard layout — 3x the bf16 param
    bytes at gather rates, but 2L+1 latency rounds, which is what makes
    FSDP a LAN/single-site plan and never a WAN one."""
    layers = ctx.wl.cfg.n_layers
    s = _state_byte_scale(ctx)
    return 2 * layers * _gather_collective_time(
        ctx.p_bytes * s / layers, ctx.n, ctx.topo, ctx.sel, ctx.cal) \
        + _gather_collective_time(ctx.g_bytes * s, ctx.n, ctx.topo,
                                  ctx.sel, ctx.cal)


# ---- p2p components ------------------------------------------------- #

def _no_p2p(ctx: CostContext) -> float:
    """Collective-only techniques send nothing point-to-point."""
    return 0.0


def _pipeline_p2p(ctx: CostContext) -> float:
    """Per-boundary microbatch activation carriers: each microbatch
    crosses each stage boundary twice (fwd + bwd), paying that
    boundary's own link (N=2: the single WAN link).  Byte terms scale
    with the carrier dtype (``carrier_scale``); latency rounds do not."""
    g = ctx.pipeline()
    wl, topo, order = ctx.wl, ctx.topo, g.order
    carrier_bytes = ctx.act_stream_bytes * ctx.carrier_scale

    def boundary_s(link: Link) -> float:
        return 2 * (wl.microbatches * (carrier_bytes / wl.microbatches)
                    / (link.effective_gbps * 1e9)
                    + wl.microbatches * link.latency_s)

    p2p = sum(boundary_s(_cal_link(ctx.cal, topo, a, b))
              for a, b in zip(order[:-1], order[1:]))
    if g.kind == "interleaved" and g.n_stages > 1:
        # v virtual stages per device: every microbatch walks the
        # stage ring v times — each forward boundary link v times
        # and the wrap-around link (last stage back to first)
        # v - 1 times.  This is the schedule's price: the bubble
        # shrinks by v, the p2p bill grows by ~v.
        wrap = _cal_link(ctx.cal, topo, order[-1], order[0])
        p2p = g.virt * p2p + (g.virt - 1) * 2 * (
            carrier_bytes / (wrap.effective_gbps * 1e9)
            + wl.microbatches * wrap.latency_s)
    return p2p


# ---- memory component ----------------------------------------------- #

def _pipeline_act_factor(ctx: CostContext) -> float:
    """In-flight microbatches make Pipeshard the memory-hungry plan
    (paper §IV-G observation 3); 1F1B caps the stash at min(S, m) — the
    schedule dimension's memory lever (docs/schedules.md)."""
    inflight = pipeline_inflight_microbatches(
        ctx.schedule, ctx.pipeline().n_stages, ctx.wl.microbatches)
    return 1 + 0.5 * inflight


@dataclass(frozen=True)
class MemoryModel:
    """Per-GPU memory as explicit replication fractions of the train
    state, instead of per-technique inlined arithmetic.

    The fp32 train state (p+g+m+v, ``Workload.bytes_train_state``) is
    split into the bf16 param working copy (``Workload.bytes_params``)
    and the rest (grads + fp32 master + Adam moments, which every
    ZeRO-style stage partitions together):

    Attributes:
        params: where the bf16 param copy lives — ``"replicated"``
            (every GPU holds it all), ``"pool"`` (sharded over all n
            GPUs), or ``"tp"`` (sharded over the intra-site
            tensor-parallel group only).
        rest: where grads + optimizer state live — ``"replicated"`` or
            ``"pool"``.
        act_factor: multiplier on the per-GPU activation bytes (1.5 for
            intra-op all-gather buffers, a schedule-dependent callable
            for Pipeshard's in-flight stash).
    """
    params: str = "replicated"
    rest: str = "replicated"
    act_factor: Union[float, Callable[[CostContext], float]] = 1.0

    def state_bytes(self, ctx: CostContext) -> float:
        """Per-GPU bytes of params + grads + optimizer state."""
        if self.params == "replicated" and self.rest == "replicated":
            return ctx.state
        if self.params == "pool" and self.rest == "pool":
            return ctx.state / ctx.n
        if self.params == "replicated" and self.rest == "pool":
            return ctx.p_bytes + (ctx.state - ctx.p_bytes) / ctx.n
        if self.params == "tp" and self.rest == "pool":
            return ctx.p_bytes / ctx.tp \
                + (ctx.state - ctx.p_bytes) / ctx.n
        raise ValueError(f"unsupported memory placement "
                         f"(params={self.params!r}, rest={self.rest!r})")

    def mem_gb(self, ctx: CostContext) -> float:
        f = self.act_factor(ctx) if callable(self.act_factor) \
            else self.act_factor
        return (self.state_bytes(ctx) + f * ctx.act) / 1e9 + ctx.ovh


# ---- the registry --------------------------------------------------- #

@dataclass(frozen=True)
class TechniqueSpec:
    """A technique's price, assembled from composable cost components.

    Attributes:
        name: technique name (``core.plans.PLANS`` key).
        compute: ``(CostContext) -> seconds`` pace-setter term.
        collective: ``(CostContext) -> seconds`` collective traffic.
        memory: the per-GPU ``MemoryModel``.
        p2p: ``(CostContext) -> seconds`` point-to-point traffic
            (pipeline boundary carriers; zero for flat pools).
        paper: True for the paper's four Algorithm-1 techniques.
        summary: one-line description for docs/CLIs.
        comm_precision: which fractions of the technique's collective
            volume may ride a sub-fp32 ``wire_dtype``
            (docs/quantization.md); the default quantizes everything.
    """
    name: str
    compute: Callable[[CostContext], float]
    collective: Callable[[CostContext], float]
    memory: MemoryModel
    p2p: Callable[[CostContext], float] = _no_p2p
    paper: bool = False
    summary: str = ""
    comm_precision: CommPrecision = CommPrecision()


TECHNIQUE_SPECS: Dict[str, TechniqueSpec] = {}


def register_technique(spec: TechniqueSpec, *,
                       replace: bool = False) -> TechniqueSpec:
    """Add a ``TechniqueSpec`` to the registry (docs/cost-model.md
    walks through adding one).

    Args:
        spec: the spec to register under ``spec.name``.
        replace: allow overwriting an existing spec.

    Raises:
        ValueError: the name is taken and ``replace`` is False.
    """
    if spec.name in TECHNIQUE_SPECS and not replace:
        raise ValueError(f"technique {spec.name!r} already registered; "
                         f"pass replace=True to override")
    TECHNIQUE_SPECS[spec.name] = spec
    return spec


register_technique(TechniqueSpec(
    "data", _pool_compute, _data_collective,
    MemoryModel("replicated", "replicated", 1.0), paper=True,
    summary="pure data parallelism: replicated state, grad all-reduce"))
register_technique(TechniqueSpec(
    "zero2", _pool_compute, _zero2_collective,
    # fp16 replica + partitioned fp32 states: the paper's low-memory plan
    MemoryModel("replicated", "pool", 1.0), paper=True,
    summary="ZeRO-2: grads + optimizer state partitioned over the pool",
    # the 0.2 master-sync share of the 2.2x volume stays fp32
    comm_precision=CommPrecision(state=2.0 / 2.2)))
register_technique(TechniqueSpec(
    "shard", _pool_compute, _intraop_collective,
    # sharded states but activation replicas + all-gather buffers
    MemoryModel("pool", "pool", 1.5), paper=True,
    summary="Megatron intra-op: per-layer activation all-reduces"))
register_technique(TechniqueSpec(
    "pipeshard", _pipeline_compute, _pipeline_collective,
    MemoryModel("pool", "pool", _pipeline_act_factor),
    p2p=_pipeline_p2p, paper=True,
    summary="inter+intra-op: staged pipeline, intra-op inside each site"))
register_technique(TechniqueSpec(
    "shard_zero", _pool_compute, _shard_zero_collective,
    MemoryModel("tp", "pool", 1.5),
    summary="intra-op inside each site x ZeRO-2 across sites",
    # inter-site ZeRO sync carries the same fp32 master share as zero2
    comm_precision=CommPrecision(state=2.0 / 2.2)))
register_technique(TechniqueSpec(
    "fsdp", _pool_compute, _fsdp_collective,
    MemoryModel("pool", "pool", 1.0),
    summary="ZeRO-3/FSDP: per-layer param gathers, lowest memory",
    # of the ~3 param-volumes moved per step, the grad reduce-scatter
    # lands in fp32 master shards — the fp32 correction third
    comm_precision=CommPrecision(state=2.0 / 3.0)))

# Paper techniques first so exact-tie stable sorts keep paper winners;
# the beyond-paper specs extend, never reorder.
ALL_TECHNIQUES = TECHNIQUES + ("shard_zero", "fsdp")
assert set(ALL_TECHNIQUES) == set(TECHNIQUE_SPECS)


def technique_state_bytes(technique: str, wl: Workload,
                          cluster: ClusterLike,
                          vms: Optional[Sequence[int]] = None) -> float:
    """Per-GPU bytes of params + grads + optimizer state under a
    technique's ``MemoryModel`` — the quantity behind the
    ``fsdp <= shard_zero <= zero2 <= data`` ordering
    (tests/test_costmodel.py)."""
    spec = TECHNIQUE_SPECS[technique]
    return spec.memory.state_bytes(_make_context(wl, cluster, vms))


def memory_envelope_gb(cluster: ClusterLike,
                       vms: Optional[Sequence[int]] = None) -> float:
    """The site memory envelope every ``MemoryModel.mem_gb`` is judged
    against: the smallest participating GPU's memory in GB (the fp32
    training state must fit *everywhere* it is placed).  Exported so
    the static plan verifier (``repro.analysis.planlint``) can check
    ``technique_state_bytes`` against exactly the bound the feasibility
    filter uses."""
    topo = as_topology(cluster)
    sel = topo.select(vms)
    return min(GPUS[g].mem_gb
               for i in sel for g in topo.sites[i].gpus)


def technique_step_cost(technique: str, wl: Workload, cluster: ClusterLike,
                        vms: Optional[Sequence[int]] = None, *,
                        stage_order: Optional[Sequence[int]] = None,
                        stage_balance: str = "even",
                        stage_layers: Optional[Sequence[int]] = None,
                        schedule: str = "gpipe",
                        carrier_dtype: str = "fp32",
                        wire_dtype: str = "fp32",
                        calibration=None) -> StepCost:
    """Model one optimizer step of `technique` (paper §III) on a cluster
    or N-site topology, via the technique's registered
    ``TechniqueSpec`` components (docs/cost-model.md).

    Args:
        technique: a ``TECHNIQUE_SPECS`` key (``TECHNIQUES`` are the
            paper's four; ``ALL_TECHNIQUES`` adds ``shard_zero`` and
            ``fsdp``).
        wl: the workload being priced.
        cluster: legacy two-VM ``Cluster`` or an N-site ``Topology``.
        vms: which sites participate (None = all).  Heterogeneous GPUs
            make the *slowest* participant the pace-setter for
            data-parallel styles, while Pipeshard assigns stages per
            mesh (paper: meshes of equal capability).
        stage_order: Pipeshard only — explicit stage→site assignment;
            the pipeline crosses exactly the links between consecutive
            sites in this order, so on an asymmetric topology the order
            matters.
        stage_balance: Pipeshard only — "even" splits layers equally
            across stages (the paper's measured Alpa behavior — the
            default, so every paper artifact keeps its numbers);
            "tflops" weights stage (or chunk, under an interleaved
            schedule) sizes by per-site compute via
            ``balanced_stage_layers``.
        stage_layers: Pipeshard only — explicit per-stage layer counts
            overriding ``stage_balance``; must sum to the model's layer
            count.  Under an interleaved schedule the entries are *per
            virtual-stage chunk* (``n_stages * v`` of them, chunk c
            running on stage ``c % n_stages``).
        schedule: Pipeshard only — pipeline tick order (``SCHEDULES``,
            docs/schedules.md).  Selects the bubble term
            (``pipeline_bubble_fraction``), the activation-memory term
            (``pipeline_inflight_microbatches``), and — interleaved —
            the v-fold boundary crossings in the p2p term.
        carrier_dtype: Pipeshard only — inter-stage activation carrier
            dtype (``CARRIER_DTYPES``).  ``"bf16"`` halves the p2p byte
            terms vs the fp32 baseline; collectives and latency rounds
            are unaffected.
        wire_dtype: communication wire dtype (``WIRE_DTYPES``) — scales
            the wire-quantizable share of *collective* byte volumes per
            the technique's ``CommPrecision`` and, when narrower than
            ``carrier_dtype``, the Pipeshard p2p carriers too
            (docs/quantization.md).  ``"fp32"`` (default) is bit-for-bit
            the legacy pricing; latency rounds never scale.
        calibration: optional measured-rate overlay
            (``calib.overlay.Calibration``, docs/calibration.md).
            Sites/links it covers are priced at their fitted achieved
            rates; everything else — and ``Calibration.identity()`` —
            keeps the analytic price bit-for-bit.

    Returns:
        A ``StepCost`` (compute_s, comm_s, memory required/available).

    Raises:
        ValueError: unknown technique / carrier / wire dtype, or an
            invalid pipeline placement (bad stage order, split, balance
            mode).
    """
    try:
        spec = TECHNIQUE_SPECS[technique]
    except KeyError:
        raise ValueError(
            f"unknown technique {technique!r}; registered: "
            f"{tuple(TECHNIQUE_SPECS)}") from None
    ctx = _make_context(wl, cluster, vms, stage_order=stage_order,
                        stage_balance=stage_balance,
                        stage_layers=stage_layers, schedule=schedule,
                        carrier_dtype=carrier_dtype,
                        wire_dtype=wire_dtype,
                        comm=spec.comm_precision,
                        calibration=calibration)
    compute = spec.compute(ctx)
    comm = spec.p2p(ctx) + spec.collective(ctx)
    mem = spec.memory.mem_gb(ctx)
    return StepCost(compute, comm, mem, ctx.mem_avail)


def epoch_minutes(technique: str, wl: Workload, cluster: ClusterLike,
                  vms: Optional[Sequence[int]] = None, *,
                  stage_order: Optional[Sequence[int]] = None,
                  stage_balance: str = "even",
                  stage_layers: Optional[Sequence[int]] = None,
                  schedule: str = "gpipe",
                  carrier_dtype: str = "fp32",
                  wire_dtype: str = "fp32",
                  calibration=None) -> Optional[float]:
    """Minutes per `epochs` epochs; None when the technique OOMs (the
    paper's '×' bars).  Keyword args as ``technique_step_cost``."""
    c = technique_step_cost(technique, wl, cluster, vms,
                            stage_order=stage_order,
                            stage_balance=stage_balance,
                            stage_layers=stage_layers,
                            schedule=schedule,
                            carrier_dtype=carrier_dtype,
                            wire_dtype=wire_dtype,
                            calibration=calibration)
    if not c.fits:
        return None
    return c.total_s * wl.steps_per_epoch * wl.epochs / 60.0


def avg_tflops(technique: str, wl: Workload, cluster: ClusterLike,
               vms: Optional[Sequence[int]] = None, *,
               stage_order: Optional[Sequence[int]] = None,
               stage_balance: str = "even",
               stage_layers: Optional[Sequence[int]] = None,
               schedule: str = "gpipe",
               carrier_dtype: str = "fp32",
               wire_dtype: str = "fp32",
               calibration=None) -> Optional[float]:
    """Average achieved TFLOP/s of one step (model FLOPs / step time);
    None when the technique OOMs.  Keyword args as
    ``technique_step_cost``."""
    c = technique_step_cost(technique, wl, cluster, vms,
                            stage_order=stage_order,
                            stage_balance=stage_balance,
                            stage_layers=stage_layers,
                            schedule=schedule,
                            carrier_dtype=carrier_dtype,
                            wire_dtype=wire_dtype,
                            calibration=calibration)
    if not c.fits:
        return None
    return wl.flops_per_step / c.total_s / 1e12
