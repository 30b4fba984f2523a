"""Roofline terms of a dry-run step on the NVIDIA H100 (port of
``repro/launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, per device:

    compute    = executed_FLOPs / (devices × peak bf16 FLOP/s)
    memory     = HBM_bytes_per_device / HBM bandwidth
    collective = bytes inside a site / NVLink rate
                 + bytes that cross sites / the WAN's rate

Sources:
  * executed FLOPs and HBM bytes — the reference's closed-form per-step
    estimates (``launch/analytic.py``; its docstring says which terms
    describe the reference's program rather than the port's);
  * collective bytes — the collectives the port's step issued, each
    classified by its group's ranks against the site boundary
    (``launch/collective_trace.py``), where the reference parses them
    from the optimized HLO;
  * per-device memory — the step's peak on the meta device
    (``torch.distributed._tools.mem_tracker.MemTracker``), where the
    reference reads ``compiled.memory_analysis()``; the "does it fit the
    card's 80 GB" check.

The constants are the H100's data sheet's (``launch/mesh.py``), not
measured.  The reference's two raw fields ``hlo_flops_raw`` and
``hlo_bytes_raw`` (XLA's ``cost_analysis``) have no meaning without a
compiler and are dropped: ``to_dict`` has the reference's keys less
those two, plus ``wan_bw``.  MODEL_FLOPS = 6·N_active·D;
``useful_flops_fraction`` = MODEL_FLOPS / executed FLOPs exposes remat
and full-block-attention waste.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Sequence

from repro_torch.launch.collective_trace import (CollectiveRecord,
                                                 collective_bytes)
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, NVLINK_BW,
                                     PEAK_FLOPS_BF16, WAN_BW)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    plan: str
    flops_total: float                  # executed, all devices (analytic)
    hbm_bytes_per_device: float         # analytic stream estimate
    collective_bytes_per_device: float  # issued by the step, inside a site
    collective_breakdown: Dict[str, float]
    dcn_bytes_per_device: float         # site-crossing collective bytes
    model_flops: float
    n_devices: int
    memory_per_device_bytes: float      # the step's peak on meta
    crosses_pod: bool = False
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    ici_bw: float = NVLINK_BW           # the in-site link: NVLink 4
    wan_bw: float = WAN_BW              # the site-to-site link

    @property
    def compute_s(self) -> float:
        return self.flops_total / (self.n_devices * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        """Bytes inside a site at NVLink's rate + site-crossing bytes at
        the WAN's."""
        return self.collective_bytes_per_device / self.ici_bw \
            + self.dcn_bytes_per_device / self.wan_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_fraction(self) -> float:
        return self.model_flops / self.flops_total if self.flops_total else 0.0

    @property
    def fits_hbm(self) -> bool:
        return self.memory_per_device_bytes <= HBM_BYTES   # H100: 80 GB

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flops_fraction=self.useful_flops_fraction,
                 fits_hbm=self.fits_hbm)
        return d


def from_dry_run(records: Sequence[CollectiveRecord], analytic,
                 mem_peak: float, *, arch: str, shape: str, mesh_name: str,
                 plan: str, n_devices: int, pods: int = 1) -> Roofline:
    """The roofline of a dry-run step: ``records`` its collectives
    (``CollectiveTrace``), ``analytic`` its ``AnalyticCost``, ``mem_peak``
    its peak bytes on the meta device.  ``pods``: the sites the mesh's
    ranks lie in, ``n_devices // pods`` each, one after the other (the
    reference's ``crosses_pod``: two)."""
    crosses_pod = pods > 1
    pod_size = n_devices // pods if crosses_pod else 0
    coll = collective_bytes(records, pod_size=pod_size)
    breakdown = {k: v for k, v in coll.items() if not k.startswith("_")}
    dcn = sum(coll["_crossing"].values())  # type: ignore[union-attr]
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, plan=plan,
        flops_total=analytic.flops_total,
        hbm_bytes_per_device=analytic.hbm_bytes_per_device,
        collective_bytes_per_device=float(sum(breakdown.values())),
        collective_breakdown=dict(breakdown, crossing=coll["_crossing"]),
        dcn_bytes_per_device=float(dcn),
        model_flops=analytic.model_flops,
        n_devices=n_devices,
        memory_per_device_bytes=float(mem_peak),
        crosses_pod=crosses_pod,
    )
