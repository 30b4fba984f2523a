"""Topology-aware decode-replica placement (a copy of the reference's
``repro/serve/placement.py``; docs/serving.md §4).

Given per-site request arrival rates over an N-site topology
(``core/topology.py``), choose how many continuous-batching decode
replicas to stand up and on which site subsets: the serving sites are
partitioned into *replica groups*, each group hosts one replica whose
parallelism plan, site subset and wire dtype come from ``PlanSearch``
(with the ``Calibration`` overlay) restricted to the group's
sub-topology.  A site's traffic is served by its own group's replica;
prompts ship to the replica instances' ingress sites over the
topology's routed links, priced with the same α/β model the training
search uses — which
is exactly what makes a high-latency site earn its own local replica
(every request would otherwise pay the WAN RTT) while a LAN pair pools
capacity in one shared replica (halving its queue wait).

A group *tiles* its winning plan: if the restricted search picks a
k-site plan on a g-site group, the group runs ``g // k`` instances of
it behind one shared queue — that shared queue is the pooling win (at
equal utilization, doubling the instance pool halves the mean wait),
and it is why a LAN pair shares a group while joining a *far* site to
the pool instead costs every one of its requests the expected WAN
prompt-ship to whichever instance frees up first.

Approximations, stated once: a decode step is priced as the forward
share of the searched *train* step (``DECODE_FLOP_SHARE`` — 2 of the
6·P·T flops; the collective pattern is the same, the backward half and
the optimizer are not run); queue wait is M/D/1 on the pooled capacity
(Poisson arrivals, deterministic service): ``rho / (2 mu (1 - rho))``;
and dispatch across a group's instances is capacity-uniform (the shared
queue is work-conserving), so a request's prompt-ship cost is the mean
over instance primaries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import Workload
from repro_torch.core.search import PlanSearch
from repro_torch.core.topology import Topology

#: prompts ship as int32 token ids
PROMPT_BYTES_PER_TOKEN = 4.0
#: forward-only share of the 6·P·T train-step flops (2 fwd of fwd+2·bwd)
DECODE_FLOP_SHARE = 1.0 / 3.0
#: utilization ceiling — past this the M/D/1 wait is effectively a queue
#: blow-up and the group is declared infeasible
RHO_MAX = 0.95


@dataclass(frozen=True)
class ReplicaSpec:
    """One decode replica: the sites it serves and how it runs.

    Attributes:
        serves: site indices whose traffic routes to this replica.
        compute_sites: the subset actually running the plan (the
            restricted search's winner, mapped back to topology indices).
        plan_key: the winning ``Candidate.key`` (technique@sites~wire).
        n_instances: plan instances tiled over the group's sites, all
            behind one shared queue (``len(serves) // len(compute_sites)``,
            at least 1; extra instances are priced at the winner's rate —
            a homogeneity approximation the docstring above owns up to).
        primaries: one ingress site per instance (first site of each
            tile, in sorted group order); prompts ship to the mean of
            these under capacity-uniform dispatch.
        decode_step_s: modelled seconds per decode step (all slots).
        prefill_s: modelled seconds to prefill one prompt.
        rho: utilization λ/μ of the *pooled* capacity under the group's
            summed rates.
        wait_s: shared-queue M/D/1 mean wait at that utilization.
    """
    serves: Tuple[int, ...]
    compute_sites: Tuple[int, ...]
    plan_key: str
    n_instances: int
    primaries: Tuple[int, ...]
    decode_step_s: float
    prefill_s: float
    rho: float
    wait_s: float


@dataclass(frozen=True)
class PlacementPlan:
    """A full serving placement: one replica per group + its objective.

    ``mean_latency_s`` is the rate-weighted mean per-request latency
    (prompt ship + queue wait + prefill + ``gen_len`` decode steps) —
    the quantity ``place_replicas`` minimizes.
    """
    replicas: Tuple[ReplicaSpec, ...]
    mean_latency_s: float
    site_latency_s: Tuple[float, ...]     # per-site mean request latency

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def groups(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(r.serves for r in self.replicas)


def partitions(items: Sequence[int]) -> Iterator[List[List[int]]]:
    """Every set partition of ``items`` (Bell(n) of them — fine for the
    site counts topologies actually have)."""
    items = list(items)
    if not items:
        yield []
        return
    head, rest = items[0], items[1:]
    for part in partitions(rest):
        for i in range(len(part)):
            yield part[:i] + [[head] + part[i]] + part[i + 1:]
        yield [[head]] + part


def _price_group(search: PlanSearch, topo: Topology, group: Sequence[int],
                 rates_rps: Sequence[float], *, slots: int,
                 prompt_len: int, gen_len: int
                 ) -> Optional[Tuple[ReplicaSpec, Dict[int, float]]]:
    """Price one replica group: among every feasible plan candidate on
    the group's sub-topology, pick the one minimizing the group's
    rate-weighted mean request latency — NOT the training-throughput
    winner.  The two disagree exactly when tiling wins: a 2-site
    pipeline out-trains two tiled single-site instances, but the tiled
    pool has more serving capacity.  Returns ``(spec, site_latency_s)``
    or None when no plan fits or every one saturates.
    """
    sub_search, kept = search.restricted(group)
    if len(sub_search.topology.components()) > 1:
        return None     # cutting the graph disconnected this group
    wl = search.wl
    ordered = tuple(sorted(group))
    lam_rps = sum(rates_rps[s] for s in ordered)
    best: Optional[Tuple[ReplicaSpec, Dict[int, float]]] = None
    best_obj = float("inf")
    for scored in sub_search.search():
        if not scored.feasible:
            break       # sorted best-first; the tail is all infeasible
        # the searched rate covers the whole train step; decode runs
        # its forward share with the same collective pattern
        step_time_s = wl.flops_per_step / (scored.tflops * 1e12)
        decode_step_s = DECODE_FLOP_SHARE * step_time_s
        prefill_flops = wl.flops_per_step * prompt_len / wl.tokens_per_step
        prefill_s = DECODE_FLOP_SHARE * prefill_flops / (scored.tflops * 1e12)
        # a request holds one slot for prefill plus gen_len decode steps
        service_s = prefill_s + gen_len * decode_step_s
        compute_sites = tuple(kept[i] for i in scored.candidate.sites)
        # tile the k-site plan across the g-site group: g // k instances
        # share one queue; leftover sites (g % k) idle
        k = len(compute_sites)
        n_instances = max(1, len(ordered) // k)
        primaries = tuple(ordered[j * k] for j in range(n_instances))
        capacity_rps = n_instances * slots / service_s
        rho = lam_rps / capacity_rps if capacity_rps > 0 else float("inf")
        if rho >= RHO_MAX:
            continue
        wait_s = rho / (2.0 * capacity_rps * (1.0 - rho))   # M/D/1
        gen_s = gen_len * decode_step_s
        site_latency_s: Dict[int, float] = {}
        obj = 0.0
        for s in ordered:
            # capacity-uniform dispatch: expected ship = mean over the
            # instances' ingress sites
            ship_s = sum(_ship_s(topo, s, p, prompt_len)
                         for p in primaries) / n_instances
            site_latency_s[s] = ship_s + wait_s + prefill_s + gen_s
            obj += rates_rps[s] * site_latency_s[s]
        if obj < best_obj:
            best_obj = obj
            spec = ReplicaSpec(ordered, compute_sites,
                               scored.candidate.key, n_instances,
                               primaries, decode_step_s, prefill_s,
                               rho, wait_s)
            best = (spec, site_latency_s)
    return best


def _ship_s(topo: Topology, src: int, dst: int, prompt_len: int) -> float:
    """Prompt-shipping seconds from the request's site to the replica's
    primary site over the (direct or routed) α/β link."""
    if src == dst:
        return 0.0
    link = topo.link(src, dst)
    return link.latency_s + \
        PROMPT_BYTES_PER_TOKEN * prompt_len / (link.effective_gbps * 1e9)


def evaluate_partition(search: PlanSearch, rates_rps: Sequence[float],
                       groups: Sequence[Sequence[int]], *, slots: int,
                       prompt_len: int, gen_len: int
                       ) -> Optional[PlacementPlan]:
    """Price one candidate partition; None when any group is infeasible."""
    topo = search.topology
    replicas: List[ReplicaSpec] = []
    site_latency_s = [0.0] * topo.n_sites
    total = 0.0
    total_rate = 0.0
    for group in groups:
        priced = _price_group(search, topo, group, rates_rps, slots=slots,
                              prompt_len=prompt_len, gen_len=gen_len)
        if priced is None:
            return None
        spec, group_latency_s = priced
        replicas.append(spec)
        for s, latency_s in group_latency_s.items():
            site_latency_s[s] = latency_s
            total = total + rates_rps[s] * latency_s
            total_rate += rates_rps[s]
    if total_rate <= 0:
        return None
    mean_latency_s = total / total_rate
    return PlacementPlan(tuple(replicas), mean_latency_s,
                         tuple(site_latency_s))


def place_replicas(search: PlanSearch, rates_rps: Sequence[float], *,
                   slots: int = 8, prompt_len: int = 512,
                   gen_len: int = 64) -> Optional[PlacementPlan]:
    """The placement pass: minimize rate-weighted mean request latency
    over every partition of the topology's sites into replica groups.

    Args:
        search: a ``PlanSearch`` over the serving topology — its
            workload should be the decode-shaped one from
            ``decode_workload``; its ``calibration`` / ``wire_dtypes`` /
            ``techniques`` knobs all apply to every replica's plan.
        rates_rps: per-site request arrival rates (requests/second).
        slots: continuous-batching slots per replica.
        prompt_len: representative prompt length (tokens).
        gen_len: representative generation length (tokens).

    Returns:
        The best ``PlacementPlan``, or None when no partition is
        feasible (every split saturates or OOMs).
    """
    if len(rates_rps) != search.topology.n_sites:
        raise ValueError(
            f"{len(rates_rps)} rates for "
            f"{search.topology.n_sites} sites")
    best: Optional[PlacementPlan] = None
    for groups in partitions(range(search.topology.n_sites)):
        plan = evaluate_partition(search, rates_rps, groups, slots=slots,
                                  prompt_len=prompt_len, gen_len=gen_len)
        if plan is None:
            continue
        if best is None or plan.mean_latency_s < best.mean_latency_s:
            best = plan
    return best


def decode_workload(cfg, *, slots: int = 8) -> Workload:
    """The decode-step workload shape: one token per step across
    ``slots`` live slots (seq_len 1, no microbatching)."""
    return Workload(cfg, seq_len=1, global_batch=slots, steps_per_epoch=1,
                    epochs=1, microbatches=1)
