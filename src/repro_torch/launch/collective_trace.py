"""The collectives a step issues, with their bytes and groups (the port's
counterpart of ``repro/launch/hlo_parse.py``).

The reference counts collective bytes by parsing XLA's optimized HLO
text, while-loop trip counts applied, and classifies each collective as
intra-pod or pod-crossing by evaluating its ``replica_groups`` against
the pod boundary.  The port's steps run eagerly and every collective of a
step already passes through ``core.sharding``'s counted wrappers
(``all_reduce``, ``reduce_scatter``, ``all_gather``, ``broadcast`` and a
pipeline's ``exchange``), so the port records the collectives
themselves: inside a ``CollectiveTrace`` each wrapper appends its kind,
its bytes (as ``sharding.collective_counts`` counts them: the whole
tensor the collective works over, so a reduce-scatter's input, where the
reference's parse counts its result) and its group, which the trace
turns into the group's global ranks (a point-to-point handoff: this rank
and its peer).  Recording is one list append in the wrapper and changes
nothing it sends.

``crosses_sites`` replaces ``_groups_cross_pod`` and ``collective_bytes``
``collective_bytes_with_trips``, with the same dict layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core import sharding


@dataclass(frozen=True)
class CollectiveRecord:
    kind: str                 # one of ``sharding.KINDS``
    bytes: int                # as ``sharding.collective_counts`` counts
    ranks: Tuple[int, ...]    # the global ranks of its group


class CollectiveTrace:
    """Context manager: every counted collective issued inside it, in
    order, in ``records`` after it closes (which must happen while the
    process group is alive: the groups' ranks are read then)."""

    def __init__(self):
        self.records: List[CollectiveRecord] = []
        self._raw: list = []

    def __enter__(self) -> "CollectiveTrace":
        if sharding._TRACE is not None:
            raise RuntimeError("a collective trace is open already")
        self._raw = []
        sharding._TRACE = self._raw
        return self

    def __exit__(self, *exc) -> None:
        sharding._TRACE = None
        me = dist.get_rank() if self._raw else 0
        ranks_of: Dict[int, Tuple[int, ...]] = {}
        for kind, n, group in self._raw:
            if isinstance(group, int):          # a handoff's peer
                ranks = (me, group)
            else:
                key = id(group)
                if key not in ranks_of:
                    ranks_of[key] = tuple(dist.get_process_group_ranks(
                        group if group is not None else dist.group.WORLD))
                ranks = ranks_of[key]
            self.records.append(CollectiveRecord(kind, n, ranks))
        self._raw = []


def crosses_sites(ranks: Sequence[int], pod_size: int) -> bool:
    """Does a group of global ranks span a site (pod) boundary?  Ranks
    lie pod after pod, ``pod_size`` a pod (the production meshes' layout);
    ``pod_size`` <= 0: one site, nothing crosses."""
    if pod_size <= 0:
        return False
    return min(ranks) // pod_size != max(ranks) // pod_size


def collective_bytes(records: Sequence[CollectiveRecord], pod_size: int = 0
                     ) -> Dict[str, object]:
    """Totals per collective kind, split into the bytes inside a site and
    those that cross sites: ``{kind: bytes, ..., "_crossing": {kind:
    bytes}, "_calls": {kind: calls}}`` (the reference's layout; its
    ``"_static_op_counts"`` counts ops in the HLO text, ``"_calls"`` the
    calls a step made)."""
    local = {k: 0.0 for k in sharding.KINDS}
    crossing = {k: 0.0 for k in sharding.KINDS}
    calls = {k: 0 for k in sharding.KINDS}
    for r in records:
        (crossing if crosses_sites(r.ranks, pod_size) else local)[r.kind] \
            += r.bytes
        calls[r.kind] += 1
    out: Dict[str, object] = dict(local)
    out["_crossing"] = crossing
    out["_calls"] = calls
    return out
