"""The ``Calibration`` overlay: measured rates on top of analytic prices.

A ``Calibration`` holds the two coefficient families the cost model is
linear in per ``CostContext`` (docs/calibration.md §2):

  * per-site achieved TFLOP/s (replacing the datasheet ``GPUS[...]``
    numbers that ``_make_context``/``stage_compute_tflops`` read), and
  * per-site-pair measured links — α (latency seconds) and an *achieved*
    rate in GB/s (replacing ``Topology.link``'s analytic edges).

Both maps are sparse: a site or pair with no entry falls through to the
exact analytic expression, returning the very same ``Link`` objects and
evaluating the very same ``min(GPUS[g].tflops ...)`` floats.  That makes
``Calibration.identity()`` (both maps empty) bit-for-bit equal to the
uncalibrated cost model — the differential gate in
``tests/test_calib_gates.py`` pins this with ``==`` on every searched
price.

Measured link rates are stored as *achieved effective* GB/s: the
measurement already includes every TCP-window/RTT effect, so
``MeasuredLink`` must not re-apply the analytic window clamp
(``topology.Link.effective_gbps``) on top of it.

Pair keys are end-to-end: on a routed topology (line/hub) the key
``(i, j)`` calibrates the whole relayed path between sites i and j, not
a physical edge — exactly the granularity ``Topology.link`` prices at.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

from repro_torch.core.topology import GPUS, Link, Topology


@dataclass(frozen=True)
class MeasuredLink(Link):
    """A link whose effective rate IS the measured achieved rate.

    The analytic ``Link.effective_gbps`` clamps bandwidth by the TCP
    window rule; a fitted rate was *measured through* that window, so
    re-clamping would double-count the effect.
    """

    @property
    def effective_gbps(self) -> float:
        return self.bandwidth_gbps


@dataclass(frozen=True)
class LinkRate:
    """Measured coefficients of one site pair: α in seconds, achieved
    rate in GB/s (β, the inverse bandwidth, is ``1 / (gbps * 1e9)`` —
    stored as a rate so pricing keeps the ``bytes / (gbps * 1e9)``
    expression shape of the analytic model)."""
    alpha_s: float
    gbps: float

    def link(self) -> MeasuredLink:
        return MeasuredLink(self.alpha_s, self.gbps)


def _key(i: int, j: int) -> Tuple[int, int]:
    return (i, j) if i <= j else (j, i)


@dataclass(frozen=True)
class Calibration:
    """Sparse measured-rate overlay; see the module docstring.

    Attributes:
        site_tflops: site index -> achieved per-GPU TFLOP/s (the pace of
            the slowest card of that site, the quantity
            ``_make_context`` reduces datasheet specs to).
        links: canonical ``(i, j)`` site pair (``i <= j``; ``(i, i)`` is
            site i's intra link) -> measured ``LinkRate``.
        note: free-form provenance (who measured, when, which harness).
    """
    site_tflops: Mapping[int, float] = field(default_factory=dict)
    links: Mapping[Tuple[int, int], LinkRate] = field(default_factory=dict)
    note: str = ""

    def __post_init__(self) -> None:
        # canonicalize pair keys at construction so (1, 0) and (0, 1)
        # name the same measurement regardless of who built the map
        object.__setattr__(self, "links",
                           {_key(i, j): lr
                            for (i, j), lr in self.links.items()})

    # ------------------------------------------------------------- #
    @classmethod
    def identity(cls) -> "Calibration":
        """The empty overlay: every lookup falls through to the analytic
        price.  Bit-for-bit equal to passing ``calibration=None``."""
        return cls()

    @property
    def is_identity(self) -> bool:
        return not self.site_tflops and not self.links

    # ------------------------------------------------------------- #
    # lookups — fall through to the exact analytic objects/expressions
    # ------------------------------------------------------------- #

    def gpu_tflops(self, topo: Topology, i: int) -> float:
        """Achieved per-GPU TFLOP/s of site i (pool pace = its slowest
        card); falls back to the datasheet minimum over the site."""
        got = self.site_tflops.get(i)
        if got is not None:
            return got
        return min(GPUS[g].tflops for g in topo.sites[i].gpus)

    def link(self, topo: Topology, i: int, j: int) -> Link:
        """The (measured or analytic) link between sites i and j;
        ``i == j`` is the intra-site link."""
        got = self.links.get(_key(i, j))
        if got is not None:
            return got.link()
        return topo.link(i, j)

    def spanning_links(self, topo: Topology, sites: Sequence[int]
                       ) -> List[Link]:
        """Calibrated counterpart of ``Topology.spanning_links`` (same
        pair order, same objects wherever no override exists)."""
        import itertools
        idx = topo.select(sites)
        return [self.link(topo, i, j)
                for i, j in itertools.combinations(idx, 2)]

    # ------------------------------------------------------------- #
    # JSON round-trip
    # ------------------------------------------------------------- #

    def to_json(self) -> Dict:
        return {
            "site_tflops": {str(i): t
                            for i, t in sorted(self.site_tflops.items())},
            "links": [[i, j, lr.alpha_s, lr.gbps]
                      for (i, j), lr in sorted(self.links.items())],
            "note": self.note,
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "Calibration":
        sites = {int(i): float(t)
                 for i, t in obj.get("site_tflops", {}).items()}
        links = {_key(int(i), int(j)): LinkRate(float(a), float(g))
                 for i, j, a, g in obj.get("links", [])}
        return cls(sites, links, obj.get("note", ""))

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=1, sort_keys=True) + "\n"

    @classmethod
    def loads(cls, text: str) -> "Calibration":
        return cls.from_json(json.loads(text))

    # ------------------------------------------------------------- #
    def describe(self, topo: Topology) -> str:
        """Human-readable datasheet-vs-fitted table."""
        parts = [f"calibration ({self.note or 'unnamed'}):"]
        for i, s in enumerate(topo.sites):
            sheet = min(GPUS[g].tflops for g in s.gpus)
            got = self.site_tflops.get(i)
            tag = f"{got:.2f} fitted" if got is not None else "analytic"
            parts.append(f"  S{i} {'+'.join(s.gpus)}: "
                         f"{sheet:.1f} TFLOP/s datasheet -> {tag}")
        for (i, j), lr in sorted(self.links.items()):
            parts.append(f"  S{i}--S{j}: alpha {lr.alpha_s * 1e3:.3f}ms, "
                         f"rate {lr.gbps:.3f} GB/s (measured)")
        return "\n".join(parts)
