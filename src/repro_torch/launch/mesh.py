"""Meshes of the port, and topology -> mesh mapping (port of
``repro/launch/mesh.py``).

A mesh lays the ranks of the ``torch.distributed`` world out over the
reference's axes, ``("pod", "data", "model")``: the "pod" axis is the
slow inter-site dimension, the analogue of the paper's site-to-site WAN
links.  ``make_topology_mesh`` maps an N-site ``core.topology.Topology``
selection onto it: one pod block per selected site, each site's GPUs
split over (data, model), the blocks in the order of ``sites``.  The
process group must be initialized first (``torch.distributed
.init_process_group``: NCCL on the card, gloo on the CPU), and the mesh
covers its whole world, or the ``ranks`` a placement runs on (the
reference's ``devices=``: after a site fails, its survivors' ranks,
``train.replan.placement_devices``).  A pipeline plan reshapes that mesh into
``("stage", "data", "model")`` by ``core.pipeline.pipeline_mesh``
(``make_pipeline_mesh``, ``placement_pipeline_mesh``): the stage axis
absorbs the pod axis, in the placement's stage order, then splits data.

``make_production_mesh`` lays the reference's production meshes, (16, 16)
over ``("data", "model")`` and (2, 16, 16) over ``("pod", "data",
"model")``, over a *fake* world of 256 or 512 ranks (``torch.distributed``'s
``"fake"`` backend, which moves no data): the dry run
(``launch/dryrun.py``) prices a plan on them without a card.  A real
launch never uses it.  Beside it, the H100's roofline constants
(``launch/roofline.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from repro_torch.core.sharding import Mesh
from repro_torch.core.topology import Topology


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def init_fake_world(world: int, rank: int = 0) -> None:
    """Join a fake ``torch.distributed`` world of ``world`` ranks as
    ``rank``: the ``"fake"`` backend's collectives return at once and
    move nothing, and meta tensors carry no data to move.  For the dry
    run only; a real launch joins NCCL (``init_world``)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    # the meta device named too: a pipeline's batched handoffs look their
    # backend up by the tensors' device
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=world)


def in_fake_world() -> bool:
    """Whether this process joined a fake world (``init_fake_world``)."""
    return dist.is_initialized() and "fake" in str(dist.get_backend())


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """The reference's production mesh, (16, 16) over (data, model) or,
    ``multi_pod``, (2, 16, 16) over (pod, data, model), the pod axis the
    slow inter-site one, over a fake world of 256 or 512 ranks: the one
    this process joined, or, when it joined none, one it joins now as
    ``rank`` (``init_fake_world``).  A real launch never uses it."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    world = int(np.prod(shape))
    if not dist.is_initialized():
        init_fake_world(world, rank)
    if not in_fake_world() or dist.get_world_size() != world:
        raise RuntimeError(f"the production mesh {shape} is the dry run's: "
                           f"it takes a fake world of {world} ranks, not "
                           f"{dist.get_backend()!r} of "
                           f"{dist.get_world_size()}")
    return make_host_mesh(shape, axes)


def make_host_mesh(shape: Sequence[int], axes: Sequence[str], *,
                   grid=None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over the process group's world:
    its ranks in row-major order, or laid out as ``grid``."""
    shape = tuple(int(n) for n in shape)
    grid = np.arange(int(np.prod(shape))) if grid is None \
        else np.asarray(grid)
    return Mesh(grid.reshape(shape), axes)


def _ranks(n: int, ranks) -> np.ndarray:
    """The ``n`` ranks a mesh lays out: ``ranks``, or the whole world."""
    ranks = np.arange(dist.get_world_size()) if ranks is None \
        else np.asarray(ranks, dtype=np.int64)
    if ranks.size != n:
        raise ValueError(f"the mesh needs {n} ranks, got {ranks.size}")
    return ranks


# --------------------------------------------------------------------- #
# topology sites -> mesh axes
# --------------------------------------------------------------------- #

def topology_mesh_spec(topo: Topology,
                       sites: Optional[Sequence[int]] = None, *,
                       model: int = 1
                       ) -> Tuple[Tuple[int, int, int],
                                  Tuple[str, str, str]]:
    """(shape, axes) of the mesh realizing a site selection: pod = one
    block per site (the slow inter-site dimension), each site's GPUs split
    into (data, model).  Pure function of the topology — unit-testable
    without devices; ``make_topology_mesh`` materializes it."""
    sel = topo.select(sites)
    if not sel:
        raise ValueError("empty site selection")
    per = {len(topo.sites[i].gpus) for i in sel}
    if len(per) != 1:
        raise ValueError(
            f"sites {sel} have unequal GPU counts {sorted(per)}; meshes "
            f"are rectangular — select equal-sized sites per mesh")
    n_per = per.pop()
    if n_per % model != 0:
        raise ValueError(f"model={model} does not divide the {n_per} GPUs "
                         f"per site")
    return (len(sel), n_per // model, model), ("pod", "data", "model")


def make_topology_mesh(topo: Topology,
                       sites: Optional[Sequence[int]] = None, *,
                       model: int = 1, ranks=None) -> Mesh:
    """Mesh over the world's ranks, or over ``ranks`` (the selected
    sites' GPUs, site after site), shaped after a topology site
    selection; rank blocks follow the order of ``sites``."""
    shape, axes = topology_mesh_spec(topo, sites, model=model)
    n = shape[0] * shape[1] * shape[2]
    if ranks is None and n != dist.get_world_size():
        raise ValueError(f"topology selection needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    return make_host_mesh(shape, axes, grid=_ranks(n, ranks))


def make_pipeline_mesh(shape: Sequence[int], axes: Sequence[str],
                       n_stages: int, *, stage_order=None,
                       stage_layers=None, schedule: str = "gpipe",
                       ranks=None) -> Mesh:
    """The ``(stage, data, model)`` mesh ``core.pipeline.pipeline_mesh``
    makes of the world's ranks, or of ``ranks``, laid out row-major as
    ``shape`` over ``axes`` (a sub-tuple of ``("pod", "data",
    "model")``)."""
    from repro_torch.core.pipeline import STAGED_AXES, pipeline_mesh
    n = int(np.prod(shape))
    if ranks is None and n != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    grid = pipeline_mesh(_ranks(n, ranks).reshape(tuple(shape)), axes,
                         n_stages, stage_order=stage_order,
                         stage_layers=stage_layers, schedule=schedule)
    return make_host_mesh(grid.shape, STAGED_AXES, grid=grid)


def placement_pipeline_mesh(topo: Topology, placement, *,
                            model: int = 1, ranks=None) -> Mesh:
    """Realize a searched pipeline ``core.plans.Placement`` as a staged
    mesh: one pod block per placed site, the blocks permuted into the
    placement's stage order, and its ``stage_layers`` (when present)
    shape-checked against the stage count.  Pass the same
    ``placement.stage_layers`` and ``schedule`` to
    ``core.steps.build_train_step``.  ``ranks``: the placed sites' GPUs,
    site after site in ``placement.sites`` order (default the world)."""
    shape, axes = topology_mesh_spec(topo, placement.sites, model=model)
    return make_pipeline_mesh(shape, axes, placement.n_stages,
                              stage_order=placement.pod_permutation(),
                              stage_layers=placement.stage_layers,
                              schedule=placement.schedule, ranks=ranks)


def placement_mesh(topo: Topology, plan, placement, *,
                   model: int = 1, ranks=None) -> Mesh:
    """Realize any searched ``core.plans.Placement`` for a plan: the
    staged mesh for a pipeline plan (``placement_pipeline_mesh``), the
    plain topology mesh over the placement's site subset for a flat one
    (data, zero2, shard, shard_zero, fsdp), over ``ranks`` (the placed
    sites' GPUs, ``train.replan.placement_devices``; default the
    world)."""
    if plan.pipeline:
        return placement_pipeline_mesh(topo, placement, model=model,
                                       ranks=ranks)
    return make_topology_mesh(topo, placement.sites, model=model,
                              ranks=ranks)


# NVIDIA H100 80GB HBM3 (SXM, 700.00 W power limit) roofline constants,
# from its data sheet, per card (not measured by this repository).
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW = 450e9             # bytes/s each way (NVLink 4, 18 links)
HBM_BYTES = 80e9              # bytes of HBM3 (the data sheet's 80 GB)
# a collective whose group crosses sites runs at the WAN's rate: the
# paper's site-to-site link as ``core.topology.two_site`` prices it
# (``wan_gbps`` = 3.0 GB/s, NCCL over TCP), not a property of the card
WAN_BW = 3.0e9                # bytes/s


def init_world(device: str = "cuda"):
    """Join the ``torch.distributed`` world this process was started in,
    and return this rank's device: under ``torch.distributed.run``
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) NCCL on
    ``cuda:LOCAL_RANK``, or gloo with ``device="cpu"``; started alone, a
    world of one.

    Raises:
        RuntimeError: ``device="cuda"`` and no card.
    """
    import os

    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run "
                               "on the CPU")
        dev = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device(device), "gloo"
    if "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev
