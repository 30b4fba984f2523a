"""N-site cluster topology: the generalization of the paper's two-VM world.

The paper's experiments are all two-VM FABRIC slices joined by one WAN
link; ``core/costmodel.Cluster`` reproduced exactly that shape.  This
module models the general case — a *graph* of sites:

  * a ``Site`` is a co-located GPU pool (the paper's "VM"): a list of
    (possibly heterogeneous) GPU names plus an intra-site link (PCIe);
  * a ``Topology`` is N sites plus per-pair inter-site ``Link``s, each
    with its own latency and bandwidth, subject to the same
    TCP-window-effective-throughput rule the paper measured (§II-C:
    NCCL over TCP/IP, no GPUDirect);
  * pairs without a direct link are routed over the latency-shortest
    multi-hop path (latencies add, bandwidth is the min along the path),
    so rings, stars/hubs and lines are all expressible.

``Cluster.topology()`` (core/costmodel.py) embeds every legacy two-VM
slice as the N=2 special case; ``core/search.PlanSearch`` enumerates
plans over arbitrary site subsets of a Topology.  See DESIGN.md §5.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple


# --------------------------------------------------------------------- #
# hardware vocabulary (moved here from core/costmodel.py, which re-exports)
# --------------------------------------------------------------------- #

@dataclass(frozen=True)
class GPUSpec:
    """One GPU model's achievable (not peak-marketing) capabilities.

    Attributes:
        name: short card name, a key of ``GPUS``.
        tflops: achievable mixed-precision TFLOP/s for training GEMMs.
        mem_gb: usable HBM/GDDR capacity.
        mem_bw_gbps: memory bandwidth in GB/s.
    """
    name: str
    tflops: float          # achievable mixed-precision TFLOP/s for GEMMs
    mem_gb: float
    mem_bw_gbps: float


# Achievable (not peak-marketing) numbers for the paper's cards:
GPUS = {
    # Quadro RTX 6000: 16.3 fp32 / ~32 fp16-ish; achievable trainer ~20
    "RTX": GPUSpec("RTX", 20.0, 24.0, 672.0),
    # Tesla T4: 8.1 fp32, 65 fp16 peak but bandwidth-starved; ~10 achievable
    "T4": GPUSpec("T4", 10.0, 16.0, 320.0),
    # A30: 10.3 fp32 / 165 bf16 peak; ~25 achievable with its 933 GB/s
    "A30": GPUSpec("A30", 25.0, 24.0, 933.0),
}


TCP_WINDOW_BYTES = 8e6   # effective socket window of NCCL-over-TCP streams


@dataclass(frozen=True)
class Link:
    """A (intra- or inter-site) interconnect edge.

    Attributes:
        latency_s: one-way latency in seconds (the paper reports RTTs in
            ms; builders take ``latency_ms`` and convert).
        bandwidth_gbps: GB/s usable at zero RTT — what NCCL-over-TCP
            achieves on the raw link, not the marketing line rate.
    """
    latency_s: float
    bandwidth_gbps: float  # GB/s usable at zero RTT

    @property
    def effective_gbps(self) -> float:
        """Single-stream TCP throughput is window/RTT-limited (paper §II-C:
        NCCL uses TCP/IP between VMs, no GPUDirect) — this is what makes
        Data/ZeRO2/Shard collapse on high-latency slices (Table II)."""
        if self.latency_s <= 0:
            return self.bandwidth_gbps
        return min(self.bandwidth_gbps,
                   TCP_WINDOW_BYTES / self.latency_s / 1e9)


PCIE = Link(5e-6, 12.0)   # default intra-site interconnect


@dataclass(frozen=True)
class Site:
    """A co-located GPU pool — the paper's 'VM', one node of the graph.

    Attributes:
        gpus: card names (keys of ``GPUS``), e.g. ``("RTX", "RTX")``;
            possibly heterogeneous.
        intra: the link within the site (default: PCIe).
        name: optional display name.
    """
    gpus: Tuple[str, ...]                 # e.g. ("RTX", "RTX")
    intra: Link = PCIE                    # link within the site (PCIe)
    name: str = ""

    def specs(self) -> List[GPUSpec]:
        """The ``GPUSpec`` of every GPU in this site, in order."""
        return [GPUS[g] for g in self.gpus]


def _key(i: int, j: int) -> Tuple[int, int]:
    return (i, j) if i <= j else (j, i)


@dataclass(frozen=True, eq=False)
class Topology:
    """N sites + inter-site link graph.

    ``links`` maps canonical ``(i, j)`` pairs (``i < j``) to Links; any
    pair not present is priced over the latency-shortest multi-hop path.
    """
    name: str
    sites: Tuple[Site, ...]
    links: Mapping[Tuple[int, int], Link] = field(default_factory=dict)

    # ----------------------------------------------------------------- #
    @property
    def n_sites(self) -> int:
        return len(self.sites)

    def select(self, sites: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        """Normalize a site-subset argument.

        Args:
            sites: site indices, or None for all sites.

        Returns:
            The validated tuple of site indices (order preserved).

        Raises:
            IndexError: a site index is out of range.
            ValueError: the selection contains duplicates.
        """
        idx = tuple(range(self.n_sites)) if sites is None else tuple(sites)
        for i in idx:
            if not 0 <= i < self.n_sites:
                raise IndexError(f"site {i} not in topology "
                                 f"{self.name!r} (n={self.n_sites})")
        if len(set(idx)) != len(idx):
            raise ValueError(f"duplicate sites in selection {idx}")
        return idx

    def all_gpus(self, sites: Optional[Sequence[int]] = None) -> List[GPUSpec]:
        """Every GPU of the selected sites (None = all), in site order."""
        return [GPUS[g] for i in self.select(sites)
                for g in self.sites[i].gpus]

    def direct(self, i: int, j: int) -> Optional[Link]:
        """The direct edge between sites i and j, or None if unlinked."""
        return self.links.get(_key(i, j))

    def link(self, i: int, j: int) -> Link:
        """Link between sites i and j: the site's intra link when i == j,
        the direct link if present, else the latency-shortest routed path
        (latencies add, bandwidth is the min hop)."""
        if i == j:
            return self.sites[i].intra
        d = self.direct(i, j)
        if d is not None:
            return d
        return self._route(i, j)

    def _route(self, src: int, dst: int) -> Link:
        """Dijkstra on latency; the routed 'link' keeps the path's total
        latency and its narrowest hop bandwidth — the TCP window rule then
        applies to the end-to-end RTT, which is conservative and matches
        how a single NCCL TCP stream behaves across a relay."""
        done = set()
        q = [(0.0, src, float("inf"))]
        while q:
            lat, node, bw = heapq.heappop(q)
            if node in done:
                continue
            done.add(node)
            if node == dst:
                return Link(lat, bw)
            for (a, b), l in self.links.items():
                if node not in (a, b):
                    continue
                nxt = b if a == node else a
                if nxt not in done:
                    heapq.heappush(q, (lat + l.latency_s, nxt,
                                       min(bw, l.bandwidth_gbps)))
        raise ValueError(f"sites {src} and {dst} are not connected "
                         f"in topology {self.name!r}")

    def spanning_links(self, sites: Sequence[int]) -> List[Link]:
        """Every pairwise link a collective over `sites` must cross.

        Args:
            sites: the participating site subset.

        Returns:
            One (direct or routed) ``Link`` per site pair.
        """
        idx = self.select(sites)
        return [self.link(i, j) for i, j in itertools.combinations(idx, 2)]

    def worst_link(self, sites: Sequence[int]) -> Link:
        """Bottleneck link on the spanning set: minimal effective
        throughput, ties broken by larger latency.  For a single site this
        is its intra link — the N=2 special case reduces to the legacy
        ``Cluster.wan`` field."""
        idx = self.select(sites)
        if len(idx) <= 1:
            return self.sites[idx[0]].intra if idx else PCIE
        return min(self.spanning_links(idx),
                   key=lambda l: (l.effective_gbps, -l.latency_s))

    # ----------------------------------------------------------------- #
    # topology surgery (elastic re-planning, docs/elasticity.md)
    # ----------------------------------------------------------------- #

    def without_sites(self, dead: Sequence[int]
                      ) -> Tuple["Topology", Tuple[int, ...]]:
        """The surviving topology after site failures.

        Sites are reindexed densely (links follow); the returned ``kept``
        tuple maps each *new* site index back to its old one, which is
        what lets a re-planned ``core.plans.Placement`` on the survivor
        be realized on the original devices (``train.replan``).

        Args:
            dead: old site indices that disappeared (duplicates and
                out-of-range indices are rejected via ``select``).

        Returns:
            ``(survivor, kept)`` — the degraded topology and the
            new→old index map.

        Raises:
            ValueError: every site died (nothing to re-plan onto).
        """
        gone = set(self.select(tuple(dead)) if dead else ())
        kept = tuple(i for i in range(self.n_sites) if i not in gone)
        if not kept:
            raise ValueError(f"all {self.n_sites} sites of {self.name!r} "
                             f"died — no survivor to re-plan onto")
        remap = {old: new for new, old in enumerate(kept)}
        links = {(remap[i], remap[j]): l for (i, j), l in self.links.items()
                 if i in remap and j in remap}
        name = self.name if not gone else \
            f"{self.name}-S{'S'.join(str(i) for i in sorted(gone))}"
        return Topology(name, tuple(self.sites[i] for i in kept),
                        links), kept

    def without_link(self, i: int, j: int) -> "Topology":
        """The topology with the direct edge between sites i and j
        removed (site indices unchanged).  Traffic between the pair is
        then priced over the remaining routed path — or becomes
        unreachable, which ``components`` makes visible.

        Raises:
            ValueError: no direct link exists between the pair.
        """
        k = _key(i, j)
        if k not in self.links:
            raise ValueError(f"no direct link between sites {i} and {j} "
                             f"in topology {self.name!r}")
        links = {p: l for p, l in self.links.items() if p != k}
        return Topology(f"{self.name}-L{k[0]}{k[1]}", self.sites, links)

    def components(self) -> List[Tuple[int, ...]]:
        """Connected components of the link graph, each a sorted site
        tuple, largest-first (ties: smallest leading index).  A healthy
        topology has exactly one; after ``without_sites`` /
        ``without_link`` the survivors may split, and a re-plan must
        place within a single component (collectives cannot cross a
        partition) — ``train.replan.replan`` searches each component."""
        parent = list(range(self.n_sites))

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for (i, j) in self.links:
            parent[find(i)] = find(j)
        groups: Dict[int, List[int]] = {}
        for i in range(self.n_sites):
            groups.setdefault(find(i), []).append(i)
        return sorted((tuple(sorted(g)) for g in groups.values()),
                      key=lambda g: (-len(g), g))

    # ----------------------------------------------------------------- #
    def describe(self) -> str:
        """Multi-line human-readable summary (sites, links, eff GB/s)."""
        parts = [f"{self.name}: {self.n_sites} sites"]
        for i, s in enumerate(self.sites):
            parts.append(f"  S{i} {s.name or '?'}: {'+'.join(s.gpus)}")
        for (i, j), l in sorted(self.links.items()):
            parts.append(f"  S{i}--S{j}: {l.latency_s * 1e3:.1f}ms "
                         f"{l.bandwidth_gbps:.1f}GB/s "
                         f"(eff {l.effective_gbps:.2f})")
        return "\n".join(parts)


# --------------------------------------------------------------------- #
# builders
# --------------------------------------------------------------------- #

def _norm_links(links: Mapping[Tuple[int, int], Link]
                ) -> Dict[Tuple[int, int], Link]:
    out: Dict[Tuple[int, int], Link] = {}
    for (i, j), l in links.items():
        if i == j:
            raise ValueError(f"self-link on site {i}")
        k = _key(i, j)
        if k in out and out[k] != l:
            raise ValueError(
                f"conflicting links for site pair {k}: {out[k]} vs {l}")
        out[k] = l
    return out


def make_topology(name: str, sites: Sequence[Site],
                  links: Mapping[Tuple[int, int], Link]) -> Topology:
    """Build a topology from an explicit link map.

    Args:
        name: display name.
        sites: the N sites.
        links: ``(i, j) -> Link`` in either index order; duplicate pairs
            with conflicting links are rejected.

    Returns:
        A ``Topology`` with links normalized to canonical ``i < j`` keys.
    """
    return Topology(name, tuple(sites), _norm_links(links))


def two_site(name: str, gpus1: Sequence[str], gpus2: Sequence[str],
             latency_ms: float, wan_gbps: float = 3.0) -> Topology:
    """The paper's shape: two sites, one WAN link (Table I).

    Args:
        name: display name.
        gpus1: card names of site V1's GPUs.
        gpus2: card names of site V2's GPUs.
        latency_ms: WAN RTT in milliseconds.
        wan_gbps: achievable NCCL-over-TCP bandwidth in GB/s.
    """
    return make_topology(
        name,
        (Site(tuple(gpus1), name="V1"), Site(tuple(gpus2), name="V2")),
        {(0, 1): Link(latency_ms * 1e-3, wan_gbps)})


def fully_connected(name: str, sites: Sequence[Site],
                    link: Link) -> Topology:
    """N sites, every pair joined directly by the same ``link``."""
    n = len(sites)
    return make_topology(name, sites, {
        (i, j): link for i in range(n) for j in range(i + 1, n)})


def ring(name: str, sites: Sequence[Site],
         links: Sequence[Link]) -> Topology:
    """N sites on a cycle; ``links[k]`` joins site k and (k+1) % N.

    Args:
        name: display name.
        sites: >= 3 sites (two sites have a single edge — use
            ``two_site``/``line``).
        links: exactly N links, one per cycle edge.
    """
    n = len(sites)
    if n < 3:
        raise ValueError(f"a ring needs >= 3 sites (got {n}); two sites "
                         f"have a single edge — use two_site/line")
    if len(links) != n:
        raise ValueError(f"ring of {n} sites needs {n} links, "
                         f"got {len(links)}")
    return make_topology(name, sites, {
        (k, (k + 1) % n): links[k] for k in range(n)})


def line(name: str, sites: Sequence[Site],
         links: Sequence[Link]) -> Topology:
    """N sites on a path; ``links[k]`` joins site k and k+1.  Non-adjacent
    pairs are priced over the (unique) routed path."""
    n = len(sites)
    if len(links) != n - 1:
        raise ValueError(f"line of {n} sites needs {n - 1} links")
    return make_topology(name, sites, {
        (k, k + 1): links[k] for k in range(n - 1)})


def hub(name: str, hub_site: Site, leaves: Sequence[Site],
        spoke: Link) -> Topology:
    """Star topology: site 0 is the hub, leaf↔leaf traffic relays
    through it (two spoke hops).

    Args:
        name: display name.
        hub_site: the central site (index 0 of the result).
        leaves: the spoke sites (indices 1..N-1).
        spoke: the hub↔leaf link, shared by every spoke.
    """
    sites = (hub_site,) + tuple(leaves)
    return make_topology(name, sites, {
        (0, k): spoke for k in range(1, len(sites))})
