"""Where a plan runs on an N-site topology: ``Placement``, a copy of
``repro.core.plans.Placement``.

The reference module also holds the four execution plans as jax mesh
shardings; their torch counterparts (plans on ``torch.distributed``)
come with the training slice.  The search, the selector and the
calibration micro-bench need only ``Placement``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Placement:
    """Where (and how) a plan runs on an N-site topology
    (core/topology.py).

    Produced by ``core.search.PlanSearch`` and handed to a prober
    (``core.selector``); the reference's launch layer turns it into a
    mesh, the port's waits for the training slice.  See
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
