"""General plan search over an N-site topology (DESIGN.md §5,
docs/topology-and-search.md).

``PlanSearch`` enumerates (technique × site-subset × stage-assignment ×
schedule) candidates on a ``core.topology.Topology`` and prices each
with the cost model — the general machine behind the paper's
Algorithm 1:

  * ``search()``/``best()`` rank the candidate space: every non-empty
    site subset for every technique, for Pipeshard every stage→site
    order (paths, deduplicated up to reversal) and every pipeline
    tick-order schedule (GPipe / 1F1B / interleaved —
    docs/schedules.md).  This is what the two-VM API could not express
    — e.g. "Data over the two nearby sites of a three-site ring,
    ignoring the far one", or "1F1B over all three sites because GPipe's
    activation stash doesn't fit".
  * the technique pool defaults to the paper's four and opens to the
    beyond-paper ``shard_zero``/``fsdp`` specs with ``techniques=
    core.costmodel.ALL_TECHNIQUES``; ``carrier_dtype="bf16"`` prices
    pipelines at halved inter-stage wire bytes (docs/cost-model.md).
  * by default the space is *pruned* — dominated site subsets are
    eliminated for the collective techniques and pipeline stage orders
    are explored with a beam over boundary-link costs — which keeps the
    search interactive up to N≈8 sites.  ``prune=False`` is the
    exactness escape hatch: it restores the exhaustive enumeration.
    Pruning is lossless for the best plan (and property-tested equal to
    exhaustive search on small N, tests/test_search.py).
  * ``select()`` runs the generalized Algorithm 1 (paper §IV-H) over the
    restricted probe set the paper defines — Pipeshard on everything,
    Data/Shard per single site, ZeRO2-on-everything fallback — with the
    same δ-threshold decision structure.  For ``n_sites == 2`` it is
    *exactly* the paper's Algorithm 1; ``core.selector.select_technique``
    is now a thin wrapper over it.

Probing is pluggable exactly like the selector's: the default evaluator
prices candidates analytically, while a ``probe_fn`` (technique,
``core.plans.Placement``) hook lets live ε-epoch training measurements
drive the same search (with pruning disabled — structural dominance
arguments only hold for the analytic cost model, not for live
measurements).  Each probe receives the candidate's full placement (site
subset, stage order, per-stage layer split), so a live probe realizes
exactly the plan being priced; probe-equivalent candidates — a stage
order and its reversal assign the same layers to the same sites and
cross the same links — are measured once via a per-search probe cache.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.costmodel import (ALL_TECHNIQUES, ClusterLike, SCHEDULES,
                                        StepCost, TECHNIQUES, Workload,
                                        _cal_intra, _cal_link, _cal_spanning,
                                        as_topology, avg_tflops,
                                        balanced_stage_layers, carrier_scale,
                                        parse_schedule, stage_compute_tflops,
                                        technique_step_cost, wire_scale)
from repro_torch.core.plans import Placement
from repro_torch.core.topology import Link, Topology

ProbeFn = Callable[[str, Optional[Placement]], Optional[float]]


# --------------------------------------------------------------------- #
# candidates
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class Candidate:
    """One point of the search space.

    Attributes:
        technique: one of ``core.costmodel.TECHNIQUES``.
        sites: the site subset the technique runs on.
        stage_order: Pipeshard only — the stage→site order the pipeline
            crosses the topology in.
        schedule: Pipeshard only — the tick-order schedule
            (``core.costmodel.SCHEDULES``, docs/schedules.md); other
            techniques keep the ignored ``"gpipe"`` default.
        wire_dtype: communication wire dtype the candidate is priced at
            (``core.costmodel.WIRE_DTYPES``; docs/quantization.md).
            ``"fp32"`` — the default and the only value enumerated
            unless ``PlanSearch.wire_dtypes`` widens the pool — is the
            legacy pricing, bit-for-bit.
    """
    technique: str
    sites: Tuple[int, ...]
    stage_order: Optional[Tuple[int, ...]] = None
    schedule: str = "gpipe"
    wire_dtype: str = "fp32"

    def placement(self) -> Placement:
        """The bare ``core.plans.Placement`` (no stage balancing; use
        ``PlanSearch.placement`` for TFLOP-weighted stage layers)."""
        return Placement(self.sites, self.stage_order,
                         schedule=self.schedule)

    @property
    def key(self) -> str:
        """Human-readable id, e.g. ``pipeshard@V1+V3|V3>V1#1f1b`` or
        ``data@V1+V2~int8`` (the wire suffix appears only off the fp32
        default)."""
        s = "+".join(f"V{i + 1}" for i in self.sites)
        if self.stage_order and self.stage_order != self.sites:
            s += "|" + ">".join(f"V{i + 1}" for i in self.stage_order)
        if self.schedule != "gpipe":
            s += f"#{self.schedule}"
        if self.wire_dtype != "fp32":
            s += f"~{self.wire_dtype}"
        return f"{self.technique}@{s}"


@dataclass(frozen=True)
class Scored:
    """A candidate plus its measured/modelled performance.

    Attributes:
        candidate: the scored candidate.
        tflops: average TFLOP/s; ``None`` on OOM / probe failure.
    """
    candidate: Candidate
    tflops: Optional[float]          # None => OOM / probe failure

    @property
    def feasible(self) -> bool:
        return bool(self.tflops)


def stage_orders(sites: Sequence[int],
                 max_orders: Optional[int] = 24, *,
                 dedupe_reversals: bool = True
                 ) -> Iterator[Tuple[int, ...]]:
    """Exhaustive pipeline stage orders over ``sites``.

    Args:
        sites: the site subset the pipeline spans.
        max_orders: optional cap on yielded orders (None = unbounded —
            required for a true exactness oracle); a cap truncates to
            the first lexicographic paths, so prefer
            ``PlanSearch.beam_stage_orders``, which caps by link cost
            rather than lexicographic accident.
        dedupe_reversals: keep only the direction with
            ``perm[0] < perm[-1]`` of each reversal pair — correct
            whenever the cost model prices both directions identically
            (links are symmetric and even splits are
            direction-invariant).  TFLOP-weighted balancing breaks the
            symmetry in rare exact-tie cases, so searches running with
            ``stage_balance="tflops"`` pass False.

    Yields:
        Site orderings.
    """
    seen = 0
    for perm in itertools.permutations(sites):
        if dedupe_reversals and perm[0] > perm[-1]:
            continue                     # canonical: keep one direction
        yield perm
        seen += 1
        if max_orders is not None and seen >= max_orders:
            return


# --------------------------------------------------------------------- #
# subset dominance (pruning, collective techniques)
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class _SubsetStats:
    """What the collective cost model can see of a site subset: the GPU
    pool size, the pace-setting GPU, the memory floor, the
    spanning-link extremes, and — for the hybrid ``shard_zero`` spec —
    the intra-site tensor-parallel floor plus each member site's intra
    all-reduce (latency, byte-rate) coefficients.  For subsets with
    equal pool sizes these numbers bound the step cost of every
    collective technique (data/zero2/shard/fsdp/shard_zero) from both
    sides."""
    subset: Tuple[int, ...]
    n_gpus: int
    min_tflops: float
    min_mem: float
    max_lat: float
    min_eff: float
    span: Tuple[Link, ...]
    # intra-site corners (shard_zero): per site, the affine all-reduce
    # coefficients alpha = (k-1)*lat and beta = (k-1)/k / eff_gbps —
    # site time for B bytes scales as alpha + beta*B.
    tp: int = 1
    intra_corners: Tuple[Tuple[float, float], ...] = ()

    @property
    def max_intra_alpha(self) -> float:
        return max((a for a, _ in self.intra_corners), default=0.0)

    @property
    def max_intra_beta(self) -> float:
        return max((b for _, b in self.intra_corners), default=0.0)


def _dominates(a: _SubsetStats, b: _SubsetStats, *,
               intra_sensitive: bool = False) -> bool:
    """True when subset ``a`` is provably at least as good as ``b`` for
    every collective technique in play: the pools are the same size
    (collective time and per-GPU memory are not monotone in pool size),
    ``a``'s slowest GPU and smallest memory are no worse, and ``b``'s
    spanning set contains a link at least as bad as ``a``'s worst-case
    (max-latency, min-throughput) corner — so ``b``'s collective time is
    >= ``a``'s for any message size, and anything that fits on ``b``
    fits on ``a``.  With ``intra_sensitive`` (the ``shard_zero`` spec in
    the pool), two extra corners must hold: ``a``'s tensor-parallel
    floor is no smaller (its ZeRO volume g/tp and its p/tp param bytes
    are no larger), and ``b`` has a member site whose intra all-reduce
    coefficients are at least as bad as ``a``'s worst — so ``b``'s
    max-over-sites intra term is >= ``a``'s for any payload."""
    if a.n_gpus != b.n_gpus:
        return False
    if a.min_tflops < b.min_tflops or a.min_mem < b.min_mem:
        return False
    if intra_sensitive:
        if a.tp < b.tp:
            return False
        if not any(al >= a.max_intra_alpha and be >= a.max_intra_beta
                   for al, be in b.intra_corners):
            return False
    return any(l.latency_s >= a.max_lat and l.effective_gbps <= a.min_eff
               for l in b.span)


# --------------------------------------------------------------------- #
# the search
# --------------------------------------------------------------------- #

@dataclass
class PlanSearch:
    """Enumerate + price candidate plans for a workload on a topology.

    Attributes:
        wl: the workload being placed.
        topology: the N-site topology (or use ``for_cluster`` to lift a
            legacy two-VM ``Cluster``).
        techniques: techniques to consider (default: the paper's four,
            ``core.costmodel.TECHNIQUES``; pass ``core.costmodel
            .ALL_TECHNIQUES`` to open the pool to the ``shard_zero`` /
            ``fsdp`` specs — every plan ``core.plans.PLANS`` executes).
        max_sites: cap subset size (None = up to all N sites).
        max_stage_orders: optional cap on stage orders per subset.  None
            (the default) keeps ``prune=False`` a true exactness oracle
            — every canonical order is enumerated.  When set, it bounds
            both paths: the exhaustive enumeration truncates (no longer
            exact!) and the beam width is clamped to it.
        probe_fn: live prober ``(technique, Placement) -> TFLOP/s``
            replacing the analytic evaluator; disables pruning.  Every
            probe carries the candidate's full placement (stage order +
            per-stage layers), and probe-equivalent candidates (reversed
            stage orders, repeated subsets) are measured once — each
            live probe is an ε-epoch training run.
        prune: eliminate dominated site subsets and beam-search stage
            orders (default).  ``prune=False`` is the exactness escape
            hatch — exhaustive enumeration, identical results, slower
            beyond N≈6.
        beam_width: beam size for stage-order search; 24 keeps subsets
            of <= 4 sites exhaustive (4!/2 = 12 canonical orders), so
            pruning only approximates on 5+-site pipelines.
        stage_balance: "even" (paper-faithful equal layer slices) or
            "tflops" (stage sizes weighted by per-site compute,
            ``core.costmodel.balanced_stage_layers``) — applied when
            pricing Pipeshard candidates and attached to placements.
        carrier_dtype: inter-stage activation carrier dtype Pipeshard
            candidates are priced at (``core.costmodel.CARRIER_DTYPES``;
            default ``"fp32"``, the legacy baseline).  ``"bf16"`` halves
            the p2p byte terms — cheap boundary bytes can flip a cell's
            stage order or schedule choice (docs/cost-model.md); the
            beam's boundary scoring uses the same scale.
        schedules: pipeline tick-order schedules to search over for
            Pipeshard candidates (``core.costmodel.SCHEDULES``; default
            all three — GPipe, 1F1B, interleaved).  Enumeration order
            breaks exact TFLOP/s ties (the sort is stable), so keeping
            ``"gpipe"`` first preserves every paper winner: 1F1B prices
            time-identical to GPipe and wins only where its smaller
            activation stash rescues a placement GPipe's ``fits`` check
            rejects.  Restrict to ``("gpipe",)`` for the legacy space
            (or to bound live-probe budgets — every schedule of every
            order is a separate ε-epoch run).
        wire_dtypes: communication wire dtypes to enumerate as a
            candidate dimension (``core.costmodel.WIRE_DTYPES``;
            docs/quantization.md).  ``None`` (default) keeps the legacy
            fp32-only space — every enumeration count and winner is
            unchanged.  Pass ``("fp32", "bf16", "int8")`` to let every
            candidate also be priced at quantized wire bytes; fp32 is
            enumerated first so exact-tie stable sorts keep legacy
            winners.  Subset dominance pruning stays lossless: a wire
            dtype rescales every subset's byte terms by the same factor
            and never touches latency or compute, so the dominance
            order between subsets is unchanged.
        calibration: optional measured-rate overlay
            (``calib.overlay.Calibration``) pricing every
            candidate — and every pruning decision — at fitted rates
            instead of datasheet/analytic ones (docs/calibration.md).
            ``None`` and ``Calibration.identity()`` are bit-for-bit
            identical to the uncalibrated search: every lookup falls
            through to the very same objects and expressions, so
            subset dominance, beam boundary scores, and prices all
            coincide (pinned by tests/test_calib_gates.py).
    """
    wl: Workload
    topology: Topology
    techniques: Tuple[str, ...] = TECHNIQUES
    max_sites: Optional[int] = None      # cap subset size (None = all N)
    max_stage_orders: Optional[int] = None
    probe_fn: Optional[ProbeFn] = None   # live prober (takes a Placement)
    prune: bool = True
    beam_width: int = 24
    stage_balance: str = "even"
    schedules: Tuple[str, ...] = SCHEDULES
    carrier_dtype: str = "fp32"
    wire_dtypes: Optional[Tuple[str, ...]] = None
    calibration: Optional[object] = None   # calib.overlay.Calibration
    # live probe memo: probe-equivalence key -> measured TFLOP/s
    _probe_cache: Dict[Tuple, Optional[float]] = field(
        default_factory=dict, init=False, repr=False, compare=False)

    @classmethod
    def for_cluster(cls, wl: Workload, cluster: ClusterLike,
                    **kw) -> "PlanSearch":
        """Lift a legacy two-VM ``Cluster`` (or pass through a
        ``Topology``) and search it."""
        return cls(wl, as_topology(cluster), **kw)

    # ------------------------------------------------------------- #
    def candidates(self) -> Iterator[Candidate]:
        """The *exhaustive* candidate space (no pruning): every
        technique on every non-empty site subset, every canonical stage
        order for Pipeshard.  ``search(prune=True)`` consumes the pruned
        twin ``pruned_candidates`` instead.  One exception under a live
        ``probe_fn``: Pipeshard stage orders are shortlisted by
        ``beam_stage_orders`` (exhaustive for subsets of <= 4 sites at
        the default width) — every shortlisted order costs a real
        ε-epoch training run, so the k!/2 enumeration is not an option;
        tighten further with ``max_stage_orders``/``beam_width``."""
        n = self.topology.n_sites
        limit = n if self.max_sites is None else min(self.max_sites, n)
        for k in range(1, limit + 1):
            for subset in itertools.combinations(range(n), k):
                for tech in self.techniques:
                    if tech == "pipeshard":
                        if k == 1:
                            continue     # 1-stage pipeline degenerates
                        # live probes pin stage orders too — the probe
                        # receives the full Placement and builds the
                        # staged mesh from it.  Each live probe is a
                        # real ε-epoch training run, so live orders are
                        # shortlisted by the (cheap, analytic) boundary
                        # -cost beam instead of enumerated k!/2-fold;
                        # the probe cache additionally keeps reversal
                        # -equivalent orders from re-measuring.
                        if self.probe_fn is not None:
                            orders = self.beam_stage_orders(subset)
                        else:
                            orders = stage_orders(
                                subset, self.max_stage_orders,
                                dedupe_reversals=self._reversible())
                        for order in orders:
                            for sched in self.schedules:
                                for wd in self._wire_pool():
                                    yield Candidate(tech, subset, order,
                                                    sched, wd)
                    else:
                        for wd in self._wire_pool():
                            yield Candidate(tech, subset, wire_dtype=wd)

    def _wire_pool(self) -> Tuple[str, ...]:
        """The wire-dtype dimension: ``("fp32",)`` (legacy space) unless
        ``wire_dtypes`` widens it.  Validates every entry."""
        if self.wire_dtypes is None:
            return ("fp32",)
        for wd in self.wire_dtypes:
            wire_scale(wd)                     # raises on unknown dtypes
        return tuple(self.wire_dtypes)

    def pruned_candidates(self) -> Iterator[Candidate]:
        """The pruned candidate space: per subset size, collective
        techniques skip dominated subsets (``_dominates`` — lossless for
        the best plan); Pipeshard explores stage orders via
        ``beam_stage_orders`` instead of exhaustively."""
        n = self.topology.n_sites
        limit = n if self.max_sites is None else min(self.max_sites, n)
        for k in range(1, limit + 1):
            subsets = list(itertools.combinations(range(n), k))
            keep = self._prune_dominated(subsets)
            for subset in subsets:
                for tech in self.techniques:
                    if tech == "pipeshard":
                        if k == 1:
                            continue
                        for order in self.beam_stage_orders(subset):
                            for sched in self.schedules:
                                for wd in self._wire_pool():
                                    yield Candidate(tech, subset, order,
                                                    sched, wd)
                    elif subset in keep:
                        for wd in self._wire_pool():
                            yield Candidate(tech, subset, wire_dtype=wd)

    def _reversible(self) -> bool:
        """Whether a stage order and its reversal are guaranteed the same
        price, so one canonical direction suffices.  True for even splits
        (links are symmetric); TFLOP-weighted splits can differ under
        exact quota ties (the tie-break is by stage position), so both
        directions must be priced."""
        return self.stage_balance != "tflops"

    def _subset_stats(self, subset: Tuple[int, ...]) -> _SubsetStats:
        # every rate below reads through the calibration overlay so the
        # dominance test compares what the evaluator will actually price
        # — pruning would stop being lossless if it kept judging subsets
        # by datasheet rates a calibration has overridden.  (min over
        # per-site minima == flat min over the pool, float-exact, so the
        # identity overlay changes nothing.)
        topo = self.topology
        cal = self.calibration
        gpus = topo.all_gpus(subset)
        span = tuple(_cal_spanning(cal, topo, subset)) if len(subset) > 1 \
            else (_cal_intra(cal, topo, subset[0]),)
        corners = []
        for i in subset:
            k = len(topo.sites[i].gpus)
            intra = _cal_intra(cal, topo, i)
            corners.append(((k - 1) * intra.latency_s,
                            (k - 1) / k / intra.effective_gbps))
        if cal is None:
            min_tflops = min(g.tflops for g in gpus)
        else:
            min_tflops = min(cal.gpu_tflops(topo, i) for i in subset)
        return _SubsetStats(
            subset=subset,
            n_gpus=len(gpus),
            min_tflops=min_tflops,
            min_mem=min(g.mem_gb for g in gpus),
            max_lat=max(l.latency_s for l in span),
            min_eff=min(l.effective_gbps for l in span),
            span=span,
            tp=min(len(topo.sites[i].gpus) for i in subset),
            intra_corners=tuple(corners))

    def _prune_dominated(self, subsets: Sequence[Tuple[int, ...]]
                         ) -> set:
        """Subsets (all the same size) worth pricing for the collective
        techniques: drop every subset strictly dominated by another, and
        keep only the lexicographically-first of exact-tie groups.  With
        ``shard_zero`` in the pool the dominance test adds its
        intra-site corners (``_dominates(intra_sensitive=True)``) so
        pruning stays lossless over the widened technique space."""
        intra = "shard_zero" in self.techniques
        stats = [self._subset_stats(s) for s in subsets]
        keep = set()
        for b in stats:
            dominated = any(
                _dominates(a, b, intra_sensitive=intra) and
                (not _dominates(b, a, intra_sensitive=intra)
                 or a.subset < b.subset)
                for a in stats if a.subset != b.subset)
            if not dominated:
                keep.add(b.subset)
        return keep

    def beam_stage_orders(self, subset: Sequence[int],
                          beam_width: Optional[int] = None
                          ) -> List[Tuple[int, ...]]:
        """Stage orders for a Pipeshard subset via beam search.

        Grows stage→site paths one site at a time, scoring partials by
        the accumulated boundary cost (the cost model's own p2p term,
        which is additive over crossed links while every other Pipeshard
        term is order-invariant up to reversal ties), and keeps the
        ``beam_width`` cheapest at each depth.  When the subset's full
        path count fits the beam this is exhaustive — with the default
        width, subsets of <= 4 sites always are.

        Args:
            subset: the site subset the pipeline spans.
            beam_width: overrides ``self.beam_width``.

        Returns:
            Orders cheapest-first; reversal pairs are deduplicated to
            the canonical direction except under ``stage_balance=
            "tflops"``, where both directions are kept (see
            ``stage_orders``).
        """
        sites = tuple(subset)
        if len(sites) <= 2:
            if len(sites) == 2 and not self._reversible():
                return [sites, sites[::-1]]
            return [sites]
        w = self.beam_width if beam_width is None else beam_width
        if self.max_stage_orders is not None:
            w = min(w, self.max_stage_orders)
        act = self.wl.tokens_per_step * self.wl.cfg.d_model * 2 \
            * carrier_scale(self.carrier_dtype)
        micro = self.wl.microbatches

        def edge_cost(a: int, b: int) -> float:
            l = _cal_link(self.calibration, self.topology, a, b)
            return 2 * (act / (l.effective_gbps * 1e9)
                        + micro * l.latency_s)

        frontier: List[Tuple[float, Tuple[int, ...]]] = \
            [(0.0, (s,)) for s in sites]
        for _ in range(len(sites) - 1):
            grown = [(cost + edge_cost(path[-1], s), path + (s,))
                     for cost, path in frontier
                     for s in sites if s not in path]
            grown.sort()
            frontier = grown[:w]
        dedupe = self._reversible()
        out: Dict[Tuple[int, ...], float] = {}
        for cost, path in frontier:
            canon = path if not dedupe or path[0] < path[-1] \
                else path[::-1]
            out.setdefault(canon, cost)
        return sorted(out, key=lambda p: (out[p], p))

    def evaluate(self, cand: Candidate) -> Optional[float]:
        """Avg TFLOP/s of a candidate; None/0 on infeasibility (OOM)."""
        if self.probe_fn is not None:
            return self._cached_probe(cand.technique, self.placement(cand))
        return avg_tflops(cand.technique, self.wl, self.topology,
                          cand.sites, stage_order=cand.stage_order,
                          stage_balance=self.stage_balance,
                          schedule=cand.schedule,
                          carrier_dtype=self.carrier_dtype,
                          wire_dtype=cand.wire_dtype,
                          calibration=self.calibration)

    def step_cost(self, cand: Candidate) -> StepCost:
        """The modelled ``StepCost`` behind ``evaluate`` — compute /
        comm seconds and the memory-vs-envelope pair, priced exactly as
        the scorer prices the candidate (same stage balance, schedule,
        carrier and wire dtypes).  The introspection hook the static
        plan verifier (``repro.analysis.planlint``) checks
        ``technique_state_bytes`` and feasibility consistency against.
        """
        place = self.placement(cand)
        return technique_step_cost(
            cand.technique, self.wl, self.topology, cand.sites,
            stage_order=cand.stage_order,
            stage_balance=self.stage_balance,
            stage_layers=place.stage_layers,
            schedule=cand.schedule,
            carrier_dtype=self.carrier_dtype,
            wire_dtype=cand.wire_dtype,
            calibration=self.calibration)

    @staticmethod
    def probe_key(technique: str, placement: Optional[Placement]) -> Tuple:
        """Probe-equivalence key: two candidates with the same key are
        guaranteed the same live measurement.  Non-pipeline techniques
        are defined by their site subset alone; a GPipe/1F1B pipeline
        and its reversal assign the same layer counts to the same sites
        and cross the same boundary links, so those reversal pairs share
        a key.  Interleaved pipelines do NOT: reversing the stage order
        re-deals the (non-contiguous) chunk→site assignment, so each
        direction keys separately."""
        if placement is None:
            return (technique, None)
        sites = tuple(placement.sites)
        if technique != "pipeshard" or len(sites) < 2:
            return (technique, sites)
        order = tuple(placement.stage_order or sites)
        layers = placement.stage_layers or ()
        _, virt = parse_schedule(placement.schedule)
        if virt > 1:
            return (technique, sites, placement.schedule, order,
                    tuple(layers))
        fwd = (order, tuple(layers))
        rev = (order[::-1], tuple(layers[::-1] if layers else ()))
        return (technique, sites, placement.schedule) + min(fwd, rev)

    def _cached_probe(self, technique: str,
                      placement: Optional[Placement]) -> Optional[float]:
        """Run ``probe_fn`` at most once per probe-equivalence class —
        every live probe is an ε-epoch training run."""
        key = self.probe_key(technique, placement)
        if key not in self._probe_cache:
            self._probe_cache[key] = self.probe_fn(technique, placement)
        return self._probe_cache[key]

    def _chunk_layers(self, order: Sequence[int],
                      schedule: str) -> Tuple[int, ...]:
        """Per-chunk layer split for a pipeline candidate: stage (chunk)
        quotas follow per-site TFLOP/s under ``stage_balance="tflops"``,
        uniform weights otherwise — largest-remainder either way, so
        non-divisible stacks still partition."""
        _, virt = parse_schedule(schedule)
        n_chunks = len(order) * virt
        if self.stage_balance == "tflops":
            tf = stage_compute_tflops(self.topology, order,
                                      self.calibration)
            weights = [tf[c % len(order)] for c in range(n_chunks)]
        else:
            weights = [1.0] * n_chunks
        return balanced_stage_layers(self.wl.cfg.n_layers, weights)

    def placement(self, cand: Candidate) -> Placement:
        """The ``core.plans.Placement`` realizing a candidate, with
        ``stage_layers`` attached when needed: TFLOP-weighted chunk
        quotas under ``stage_balance="tflops"``, and an explicit (even,
        largest-remainder) split for interleaved candidates even under
        ``"even"`` balance — interleaved chunks are non-contiguous on a
        stage, so the runtime always needs the split spelled out."""
        if cand.technique != "pipeshard" or (
                self.stage_balance != "tflops"
                and parse_schedule(cand.schedule)[1] == 1):
            return cand.placement()
        order = cand.stage_order or cand.sites
        return Placement(cand.sites, cand.stage_order,
                         self._chunk_layers(order, cand.schedule),
                         schedule=cand.schedule)

    def search(self, *, prune: Optional[bool] = None) -> List[Scored]:
        """All candidates, best first (infeasible ones at the tail).

        Args:
            prune: override the instance's ``prune`` flag for this call
                (``False`` = exhaustive exactness escape hatch).  Live
                ``probe_fn`` searches are never pruned.

        Returns:
            ``Scored`` candidates sorted by descending TFLOP/s.
        """
        do_prune = self.prune if prune is None else prune
        if self.probe_fn is not None:
            do_prune = False
        cands = self.pruned_candidates() if do_prune else self.candidates()
        scored = [Scored(c, self.evaluate(c)) for c in cands]
        return sorted(scored, key=lambda s: -(s.tflops or 0.0))

    def best(self, *, prune: Optional[bool] = None) -> Optional[Scored]:
        """The best feasible candidate, or None when everything OOMs."""
        top = self.search(prune=prune)
        return top[0] if top and top[0].feasible else None

    # ------------------------------------------------------------- #
    def restricted(self, sites: Sequence[int]
                   ) -> Tuple["PlanSearch", Tuple[int, ...]]:
        """A search over only the sub-topology spanned by ``sites``.

        The replica-placement objective (``serve/placement.py``) prices
        each candidate replica group through this: same workload and
        knobs, the topology cut down to the group, and the
        ``Calibration`` overlay's site/pair keys remapped to the dense
        sub-topology indices (sparse entries for dropped sites vanish;
        everything else keeps falling through to analytic rates).

        Returns:
            ``(search, kept)`` — ``kept[new_index] == old_index`` maps
            the sub-search's site numbering back to this topology's.
        """
        import dataclasses as _dc
        keep = set(self.topology.select(tuple(sites)))
        dead = [i for i in range(self.topology.n_sites) if i not in keep]
        sub, kept = self.topology.without_sites(dead)
        calib = self.calibration
        if calib is not None and dead:
            from repro_torch.calib.overlay import Calibration
            remap = {old: new for new, old in enumerate(kept)}
            calib = Calibration(
                site_tflops={remap[i]: v
                             for i, v in calib.site_tflops.items()
                             if i in remap},
                links={(min(remap[i], remap[j]), max(remap[i], remap[j])): r
                       for (i, j), r in calib.links.items()
                       if i in remap and j in remap},
                note=calib.note)
        return _dc.replace(self, topology=sub, calibration=calib,
                           probe_fn=None), kept

    # ------------------------------------------------------------- #
    def select(self, *, delta: float = 0.1,
               extended: Optional[bool] = None) -> "Selection":
        """Generalized Algorithm 1 over this topology (paper probe set +
        δ decision rule); the N=2 case is the paper's algorithm verbatim.

        Args:
            delta: the paper's δ threshold.
            extended: opt into the beyond-paper probe set (``shard_zero``
                / ``fsdp``, see ``algorithm1_select``).  Default: derived
                from this search's technique pool — paper-faithful four
                unless the pool itself was widened.
        """
        if extended is None:
            extended = any(t not in TECHNIQUES for t in self.techniques)
        return algorithm1_select(self._probe, self.topology.n_sites,
                                 delta=delta, extended=extended)

    def _probe(self, technique: str, placement: Optional[Placement]
               ) -> Optional[float]:
        if self.probe_fn is not None:
            if placement is not None and technique == "pipeshard" \
                    and self.stage_balance == "tflops" \
                    and placement.stage_layers is None:
                # attach the same weighted split ``placement()`` would:
                # the Algorithm-1 probe then shares its cache key with
                # the search's candidate (no duplicate ε-epoch run) and
                # a live run_fn never sees an even split that cannot
                # partition a non-divisible stack
                order = placement.stage_order or placement.sites
                placement = Placement(
                    placement.sites, placement.stage_order,
                    self._chunk_layers(order, placement.schedule),
                    schedule=placement.schedule)
            return self._cached_probe(technique, placement)
        sites = None if placement is None else list(placement.sites)
        return avg_tflops(technique, self.wl, self.topology, sites,
                          stage_order=None if placement is None
                          else placement.stage_order,
                          stage_layers=None if placement is None
                          else placement.stage_layers,
                          stage_balance=self.stage_balance,
                          schedule="gpipe" if placement is None
                          else placement.schedule,
                          carrier_dtype=self.carrier_dtype,
                          calibration=self.calibration)


# --------------------------------------------------------------------- #
# Algorithm 1, generalized to N sites
# --------------------------------------------------------------------- #

def algorithm1_select(probe: ProbeFn, n_sites: int, *,
                      delta: float = 0.1,
                      extended: bool = False) -> "Selection":
    """Algorithm 1 (paper §IV-H), lines 1-36, for N sites.

    Probes Pipeshard on all sites, Data/Shard on each site alone, and
    keeps the paper's decision structure: Pipeshard must beat the best
    single-site plan by more than δ; the tie region takes the absolute
    best; ZeRO2-on-everything is the memory-pressure fallback.  For
    ``n_sites == 2`` the probe keys, comparisons and tie-breaks are
    exactly the original two-VM algorithm's.

    ``extended`` opts into the beyond-paper pool
    (``core.costmodel.ALL_TECHNIQUES``) while keeping the paper's
    decision structure: the "on everything" tier also probes
    ``shard_zero`` and ``fsdp`` on all sites (best of the three enters
    the δ comparison, ties preferring Pipeshard), and each single site
    is additionally probed under ``fsdp`` — the memory-rescue plan that
    can revive a site whose replicated-state plans OOM
    (docs/cost-model.md).  With ``extended=False`` (the default) the
    probe set, keys, comparisons, and tie-breaks are bit-for-bit the
    paper's.

    Args:
        probe: ``(technique, Placement) -> TFLOP/s`` (None/0 =
            infeasible); the paper's probe set pins only site subsets,
            so the placements carry no stage order or layer split.
        n_sites: number of sites the probe understands.
        delta: the paper's δ threshold — how much better
            Pipeshard-on-everything must be before it wins.
        extended: add the ``shard_zero``/``fsdp`` probes (opt-in).

    Returns:
        A ``core.selector.Selection`` with the chosen technique, its
        site list, and every probe taken.
    """
    from repro_torch.core.selector import Selection

    probes: Dict[str, Optional[float]] = {}
    all_key = "both" if n_sites == 2 else "all"
    all_sites = tuple(range(n_sites))

    def run(tech: str, placement: Placement, key: str) -> float:
        perf = probe(tech, placement)
        probes[key] = perf
        return perf if perf else 0.0          # line convention: 0 on failure

    # lines 1-2: Pipeshard on the union of all sites
    t_p = run("pipeshard", Placement(all_sites), f"pipeshard@{all_key}")
    all_tech, t_all = "pipeshard", t_p
    if extended:
        # beyond-paper "on everything" probes; pipeshard keeps exact ties
        for tech in ("shard_zero", "fsdp"):
            t = run(tech, Placement(all_sites), f"{tech}@{all_key}")
            if t > t_all:
                all_tech, t_all = tech, t
    # lines 3-10: Data and Shard on each site separately
    t_d = [run("data", Placement((i,)), f"data@V{i + 1}")
           for i in range(n_sites)]
    t_s = [run("shard", Placement((i,)), f"shard@V{i + 1}")
           for i in range(n_sites)]
    t_f = [run("fsdp", Placement((i,)), f"fsdp@V{i + 1}")
           for i in range(n_sites)] if extended \
        else [0.0] * n_sites
    # line 11
    t_z = max(t_d + t_s + (t_f if extended else []))

    def best_single() -> Selection:
        # argmax over sites with first-wins ties (the paper prefers V1)
        i = max(range(n_sites),
                key=lambda k: (max(t_d[k], t_s[k], t_f[k]), -k))
        # paper-order tie-break: data, then shard, then (extended) fsdp
        if t_d[i] >= t_s[i] and t_d[i] >= t_f[i]:
            tech = "data"
        elif t_s[i] >= t_f[i]:
            tech = "shard"
        else:
            tech = "fsdp"
        return Selection(tech, [i], probes)

    every = list(range(n_sites))
    # lines 12-13: the distributed plan wins by more than δ
    if t_z > 0 and (t_all - t_z) / t_z > delta:
        return Selection(all_tech, every, probes)
    # lines 14-27: a single-site plan wins by more than δ
    if t_all > 0 and (t_z - t_all) / t_all > delta:
        return best_single()
    # tie region but something ran: prefer the absolute best measured
    if t_all > 0 or t_z > 0:
        if t_all >= t_z:
            return Selection(all_tech, every, probes)
        return best_single()
    # lines 29-35: ZeRO2 fallback on the whole cluster (in extended mode
    # the fsdp@all probe above already covered the only lower-memory
    # plan, and it OOMed too if we got here)
    t_z2 = run("zero2", Placement(all_sites), f"zero2@{all_key}")
    if t_z2 > 0:
        return Selection("zero2", every, probes)
    return Selection("none", None, probes)    # need more GPU memory
