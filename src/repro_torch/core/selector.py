"""Algorithm 1 (paper §IV-H): probe-based pretraining technique selection.

Given an SLM M and two VMs (V1, V2), probe each technique for ε epochs and
pick the one maximizing measured training performance (TFLOP/s), with a
user threshold δ controlling how much better Pipeshard-on-everything must
be before it wins over the best single-VM plan; ZeRO2-on-everything is the
memory-pressure fallback.

``select_technique`` is now a thin wrapper over the generalized N-site
``core.search.algorithm1_select`` — the two-VM algorithm is its N=2
special case, and ``core.search.PlanSearch`` explores the full
(technique × site-subset × stage-order) space beyond it (DESIGN.md §5).

Probes are pluggable: ``CostModelProber`` prices them analytically (this is
how benchmarks reproduce the paper's conclusions), while ``LiveProber``
runs the caller's ``run_fn`` for ε epochs — the shape the algorithm has
on a real cluster (the torch trainer that feeds it comes with the
training slice).  A probe receives the full ``core.plans.Placement``
(site subset + stage order + per-stage layer split), so a live probe can
realize exactly the candidate the search priced.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import torch

from repro_torch.core.costmodel import ClusterLike, Workload, \
    as_topology, avg_tflops
from repro_torch.core.plans import Placement

log = logging.getLogger(__name__)


class Prober(Protocol):
    def probe(self, technique: str, placement: Optional[Placement]
              ) -> Optional[float]:
        """Avg TFLOP/s over ε epochs; None/0 on failure (OOM).
        ``placement=None`` means all sites in default order."""


@dataclass
class CostModelProber:
    wl: Workload
    cluster: ClusterLike              # legacy two-VM Cluster or a Topology
    # optional measured-rate overlay (calib.overlay.Calibration);
    # None and the identity overlay price bit-for-bit the analytic model
    calibration: Optional[object] = None

    @property
    def n_sites(self) -> int:
        return as_topology(self.cluster).n_sites

    def probe(self, technique: str, placement: Optional[Placement]
              ) -> Optional[float]:
        if placement is None:
            return avg_tflops(technique, self.wl, self.cluster, None,
                              calibration=self.calibration)
        return avg_tflops(technique, self.wl, self.cluster,
                          list(placement.sites),
                          stage_order=placement.stage_order,
                          stage_layers=placement.stage_layers,
                          schedule=placement.schedule,
                          calibration=self.calibration)


# Failure modes that mean "this plan cannot run on this hardware" — the
# OOM/'×' outcome Algorithm 1 expects — as opposed to a programming error.
# PyTorch raises its own type for an allocation the card cannot serve
# (the reference matches XLA's resource errors by message instead).
_INFEASIBLE_TYPES = (torch.OutOfMemoryError, MemoryError)


def probe_infeasible(exc: BaseException) -> bool:
    """True when ``exc`` is a resource failure a probe may treat as
    'technique infeasible here' (returning None); everything else —
    TypeError, bad shapes, assertion failures — is a bug in the probe
    and must propagate."""
    return isinstance(exc, _INFEASIBLE_TYPES)


@dataclass
class LiveProber:
    """Runs ε epochs of real training per probe through the caller's
    ``run_fn`` (used on live hardware).

    ``run_fn(technique, placement)`` receives the full
    ``core.plans.Placement`` so it can build the exact layout the search
    priced.  Only resource/compile failures (``probe_infeasible``) are
    treated as the paper's OOM outcome; programming errors re-raise —
    silently mapping a TypeError to an OOM-style None probe would corrupt
    Algorithm 1's selection.
    """
    run_fn: Callable[[str, Optional[Placement]], Optional[float]]
    n_sites: int = 2

    def probe(self, technique: str, placement: Optional[Placement]
              ) -> Optional[float]:
        try:
            return self.run_fn(technique, placement)
        except Exception as e:
            if probe_infeasible(e):
                log.warning("probe %s@%s infeasible: %s",
                            technique, placement, e)
                return None
            log.error("probe %s@%s failed with a non-resource error "
                      "(%s) — re-raising, not treating as OOM",
                      technique, placement, type(e).__name__)
            raise


@dataclass
class Selection:
    technique: str
    vms: Optional[List[int]]          # None => infeasible everywhere
    probes: Dict[str, Optional[float]]

    @property
    def feasible(self) -> bool:
        return self.vms is not None or self.technique == "none"


def select_technique(prober: Prober, *, delta: float = 0.1,
                     extended: bool = False) -> Selection:
    """Algorithm 1, lines 1-36 — the N=2 (or prober-declared N) case of
    ``core.search.algorithm1_select``.

    Args:
        prober: probe provider (``CostModelProber`` / ``LiveProber``).
        delta: the paper's δ threshold.
        extended: opt into the beyond-paper ``shard_zero``/``fsdp``
            probes (``core.costmodel.ALL_TECHNIQUES``); the default
            keeps the paper's four-technique probe set bit-for-bit.
    """
    from repro_torch.core.search import algorithm1_select
    n_sites = getattr(prober, "n_sites", 2)
    return algorithm1_select(prober.probe, n_sites, delta=delta,
                             extended=extended)
