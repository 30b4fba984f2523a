"""Elastic re-planning: lose a site mid-run, search the survivors, resume
(port of ``repro/train/replan.py``).

The recovery path, as in the reference:

  1. a deterministic fault (``SiteFailure``, injected through
     ``train(on_step_failure=...)`` by ``kill_site_at``) stops the run
     at an exact step, on every rank alike;
  2. ``replan`` drops the dead sites from the ``core.topology.Topology``,
     splits the survivors into connected ``components``, runs
     ``core.search.PlanSearch`` inside each and keeps the best feasible
     plan, with the index maps back to the original topology;
  3. ``reshard_checkpoint`` restores the newest complete checkpoint
     straight onto the new plan's layout (``train.reshard``): params and
     AdamW moments bit-exact, no recomputation;
  4. ``train(start_step=..., sharded=True)`` resumes against the same
     deterministic batch sequence.

Sites own ranks of the ``torch.distributed`` world (one a GPU, site
after site: ``site_device_blocks``), the port's counterpart of the
reference's device blocks.  Every rank runs the fault hook, the replan
and the survivors' mesh build alike (``torch.distributed`` wants every
group made by every rank of the world); then the ranks of the dead
sites leave the run: no step, no write, no collective of the survivors.
"""
from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import TrainConfig
from repro_torch.core.costmodel import TECHNIQUES, Workload
from repro_torch.core.plans import Placement, get_plan
from repro_torch.core.search import PlanSearch
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import placement_mesh
from repro_torch.models.model import Model
from repro_torch.optim import init_adamw
from repro_torch.train.checkpoint import latest_checkpoint, save_checkpoint
from repro_torch.train.loop import TrainResult, train
from repro_torch.train.reshard import reshard_checkpoint


class SiteFailure(RuntimeError):
    """A site (or set of sites) dropped out at a training step.

    Raised from a ``train(on_step_failure=...)`` hook; ``train`` attaches
    the partial ``TrainResult`` as the exception's ``result`` attribute
    before re-raising.

    Attributes:
        step: the absolute step the failure struck at (that step and
            everything after it did not execute).
        dead_sites: original-topology indices of the lost sites.
    """

    def __init__(self, step: int, dead_sites: Sequence[int],
                 reason: str = "site lost"):
        self.step = int(step)
        self.dead_sites = tuple(int(i) for i in dead_sites)
        super().__init__(
            f"step {self.step}: site(s) "
            f"{'+'.join(f'V{i + 1}' for i in self.dead_sites)} "
            f"failed ({reason})")


def kill_site_at(step: int, dead_sites: Sequence[int]
                 ) -> Callable[[int], None]:
    """Deterministic fault injector for ``train(on_step_failure=...)``:
    raises ``SiteFailure(step, dead_sites)`` the moment the run reaches
    ``step``."""
    dead = tuple(dead_sites)

    def hook(i: int) -> None:
        if i == step:
            raise SiteFailure(i, dead)

    return hook


@dataclass(frozen=True)
class ReplanResult:
    """What the survivor search decided.

    Attributes:
        topology: the component sub-topology the winner was searched on
            (site indices are local to it).
        technique: winning technique (a ``core.plans.PLANS`` key).
        placement: winning ``core.plans.Placement``, indexing
            ``topology``.
        sites_old: per placed site, its index in the original topology
            (``placement_devices`` re-uses its ranks).
        tflops: the cost model's score for the winner.
        search_s: wall-clock seconds the survivor search took.
        dead_sites: original indices of the sites that were removed.
    """
    topology: Topology
    technique: str
    placement: Placement
    sites_old: Tuple[int, ...]
    tflops: float
    search_s: float
    dead_sites: Tuple[int, ...]


def replan(topo: Topology, dead_sites: Sequence[int], wl: Workload, *,
           techniques: Tuple[str, ...] = TECHNIQUES,
           stage_balance: str = "tflops",
           schedules: Optional[Tuple[str, ...]] = None,
           **search_kw) -> ReplanResult:
    """Search the surviving topology for the best feasible plan: drop
    ``dead_sites``, search each connected component of the survivors
    (a plan cannot span sites with no path between them), and return the
    best candidate with its sites mapped back to the original topology.

    Raises:
        ValueError: ``dead_sites`` is empty or invalid, or kills every
            site.
        RuntimeError: no surviving component has a feasible plan (every
            candidate exceeds memory).
    """
    if not dead_sites:
        raise ValueError("replan without dead sites — nothing to do")
    t0 = time.perf_counter()
    survivor, kept = topo.without_sites(dead_sites)
    if schedules is not None:
        search_kw["schedules"] = tuple(schedules)
    best = None
    for comp in survivor.components():
        drop = [i for i in range(survivor.n_sites) if i not in comp]
        sub, sub_kept = survivor.without_sites(drop) if drop \
            else (survivor, tuple(range(survivor.n_sites)))
        search = PlanSearch(wl, sub, techniques=tuple(techniques),
                            stage_balance=stage_balance, **search_kw)
        top = search.best()
        if top is not None and (best is None or top.tflops > best[0]):
            best = (top.tflops, search, top, sub, sub_kept)
    if best is None:
        raise RuntimeError(
            f"no feasible plan on the survivors of {topo.name} minus "
            f"{tuple(dead_sites)} — every candidate exceeds memory")
    tflops, search, top, sub, sub_kept = best
    placement = search.placement(top.candidate)
    sites_old = tuple(kept[sub_kept[s]] for s in placement.sites)
    return ReplanResult(
        topology=sub, technique=top.candidate.technique,
        placement=placement, sites_old=sites_old, tflops=float(tflops),
        search_s=time.perf_counter() - t0,
        dead_sites=tuple(int(i) for i in dead_sites))


# --------------------------------------------------------------------- #
# site -> rank blocks (one rank a GPU, in site order)
# --------------------------------------------------------------------- #

def site_device_blocks(topo: Topology, ranks=None) -> List[Tuple]:
    """Per-site blocks of ranks, one a GPU: site i owns the next
    ``len(topo.sites[i].gpus)`` of ``ranks`` (default the world's,
    ``0 .. world - 1``).  Fixing the blocks up front means a replanned
    run re-uses exactly the surviving sites' ranks.

    Raises:
        ValueError: fewer ranks than the topology has GPUs.
    """
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    blocks, off = [], 0
    for s in topo.sites:
        n = len(s.gpus)
        if off + n > len(ranks):
            raise ValueError(f"topology {topo.name} needs "
                             f"{sum(len(t.gpus) for t in topo.sites)} "
                             f"devices (ranks), have {len(ranks)}")
        blocks.append(tuple(ranks[off:off + n]))
        off += n
    return blocks


def placement_devices(blocks: Sequence[Tuple],
                      sites_old: Sequence[int]) -> List:
    """The ranks of a placement's sites (``ReplanResult.sites_old``
    order), flattened: what ``launch.mesh.placement_mesh`` takes as
    ``ranks``."""
    return [d for i in sites_old for d in blocks[i]]


# --------------------------------------------------------------------- #
# elastic training: fail, replan, reshard, resume
# --------------------------------------------------------------------- #

@dataclass
class ElasticRun:
    """One rank's view of an elastic run and its recovery accounting.

    Attributes:
        result: the final ``TrainResult`` (the post-recovery segment
            when a failure struck, else the whole run; empty on a rank
            that took no step in it).
        pre: the pre-failure partial ``TrainResult`` (None: no failure).
        failure: the ``SiteFailure`` that struck (None: clean run).
        replan: the survivor search's ``ReplanResult`` (None: clean run).
        resumed_from: checkpoint step the recovery restarted at.
        steps_lost: steps re-executed = failure step - checkpoint step.
        search_s / reshard_s / recovery_s: recovery wall-clocks (recovery
            covers search, mesh, restore and reshard, not the resumed
            training).
        mesh: the mesh of the final segment.
        left: this rank is on none of the final segment's sites (a dead
            site's): it left the run after the replan.
    """
    result: TrainResult
    pre: Optional[TrainResult] = None
    failure: Optional[SiteFailure] = None
    replan: Optional[ReplanResult] = None
    resumed_from: Optional[int] = None
    steps_lost: int = 0
    search_s: float = 0.0
    reshard_s: float = 0.0
    recovery_s: float = 0.0
    mesh: Any = None
    left: bool = False

    @property
    def failed(self) -> bool:
        return self.failure is not None

    @property
    def main(self) -> bool:
        """Whether this rank writes and reports for the final segment."""
        return not self.left and dist.get_rank() == self.mesh.first_rank

    @property
    def losses(self) -> List[float]:
        """Pre-failure + post-recovery losses in executed order
        (re-executed steps appear twice, as they ran twice)."""
        pre = self.pre.losses if self.pre else []
        return list(pre) + list(self.result.losses)


def train_elastic(model: Model, topo: Topology, technique: str,
                  placement: Placement, tcfg: TrainConfig, loader, *,
                  steps: int, ckpt_dir: str, ckpt_every: int = 1,
                  on_step_failure: Optional[Callable[[int], None]] = None,
                  ranks=None, model_axis: int = 1,
                  techniques: Tuple[str, ...] = TECHNIQUES,
                  log_every: int = 0,
                  log_fn: Callable[[str], None] = print,
                  **search_kw) -> ElasticRun:
    """Run a plan with fault tolerance, on every rank of the world alike:
    on ``SiteFailure``, replan over the survivors, reshard the newest
    checkpoint onto the winner, and resume.

    A step-0 checkpoint is saved before training starts (params and
    optimizer state initialized here from ``tcfg.seed``), so recovery is
    possible even before the first periodic checkpoint lands.  A rank
    of no placed site takes no step but meets the fault hook at each
    step, so that it builds the survivors' mesh with the others (and
    takes part in it when the winner places its site).

    Args:
        model: the model to train (on this rank's device).
        topo: the full (pre-failure) topology.
        technique: initial plan name (``core.plans.PLANS`` key).
        placement: initial ``core.plans.Placement`` on ``topo``.
        tcfg: training config.
        loader: deterministic ``data.pipeline.Loader``.
        steps: total steps to reach (absolute).
        ckpt_dir: checkpoint directory (required: it is the recovery
            mechanism), shared by the ranks.
        ckpt_every: periodic checkpoint interval in steps.
        on_step_failure: fault hook forwarded to ``train`` (e.g.
            ``kill_site_at``); fires on the first segment only.
        ranks: the world's ranks the topology's GPUs own, site after
            site (default the world; ``site_device_blocks``).
        model_axis: tensor-parallel degree inside each site.
        techniques: survivor-search technique pool.
        log_every / log_fn: forwarded to ``train``.
        **search_kw: forwarded to ``replan`` / ``PlanSearch``.

    Returns:
        This rank's ``ElasticRun``: clean, recovered, or ``left``.

    Raises:
        RuntimeError: no feasible plan on the survivors, or no complete
            checkpoint to recover from.
    """
    if not ckpt_dir:
        raise ValueError("train_elastic needs ckpt_dir — checkpoints are "
                         "the recovery mechanism")
    plan = get_plan(technique)
    blocks = site_device_blocks(topo, ranks)
    mesh = placement_mesh(topo, plan, placement, model=model_axis,
                          ranks=placement_devices(blocks, placement.sites))
    params = opt_state = None
    try:
        if not mesh.holds_me:
            for i in range(steps):           # a spare rank: no step
                if on_step_failure is not None:
                    on_step_failure(i)
            return ElasticRun(result=TrainResult(), mesh=mesh, left=True)
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(tcfg.seed))
        opt_state = init_adamw(params)
        if dist.get_rank() == mesh.first_rank:
            save_checkpoint(ckpt_dir, 0, params, opt_state)
        mesh.barrier()
        res = train(model, tcfg, loader, steps=steps, params=params,
                    opt_state=opt_state, ckpt_dir=ckpt_dir,
                    ckpt_every=ckpt_every,
                    stage_layers=placement.stage_layers,
                    schedule=placement.schedule,
                    on_step_failure=on_step_failure, log_every=log_every,
                    log_fn=log_fn, plan=plan, mesh=mesh)
        return ElasticRun(result=res, mesh=mesh)
    except SiteFailure as fail:
        # the failed segment's frames hold its params and moments
        traceback.clear_frames(fail.__traceback__)
        pre = getattr(fail, "result", TrainResult())
        failure = fail
    del params, opt_state
    first = loader.batch_at(0)
    wl = Workload(model.cfg, int(first["tokens"].shape[1]),
                  loader.global_batch, steps_per_epoch=steps,
                  microbatches=tcfg.microbatches)
    t0 = time.perf_counter()
    rp = replan(topo, failure.dead_sites, wl, techniques=techniques,
                **search_kw)
    plan2 = get_plan(rp.technique)
    mesh2 = placement_mesh(rp.topology, plan2, rp.placement,
                           model=model_axis,
                           ranks=placement_devices(blocks, rp.sites_old))
    if not mesh2.holds_me:                  # a dead site's rank leaves
        return ElasticRun(result=TrainResult(), pre=pre, failure=failure,
                          replan=rp, search_s=rp.search_s, mesh=mesh2,
                          left=True)
    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is None:
        raise RuntimeError(f"no complete checkpoint in {ckpt_dir} to "
                           f"recover from") from failure
    t1 = time.perf_counter()
    params2, opt2, step0 = reshard_checkpoint(
        ckpt, model, plan2, mesh2, placement=rp.placement)
    t2 = time.perf_counter()
    if dist.get_rank() == mesh2.first_rank:
        log_fn(f"recovered at step {step0}: {rp.technique}@"
               f"{'+'.join(f'V{i + 1}' for i in rp.sites_old)} "
               f"(search {rp.search_s:.2f}s, reshard {t2 - t1:.2f}s, "
               f"{failure.step - step0} step(s) lost)")
    post = train(model, tcfg, loader, steps=steps, start_step=step0,
                 params=params2, opt_state=opt2, sharded=True,
                 ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                 stage_layers=rp.placement.stage_layers,
                 schedule=rp.placement.schedule, log_every=log_every,
                 log_fn=log_fn, plan=plan2, mesh=mesh2)
    return ElasticRun(result=post, pre=pre, failure=failure, replan=rp,
                      resumed_from=step0, steps_lost=failure.step - step0,
                      search_s=rp.search_s, reshard_s=t2 - t1,
                      recovery_s=t2 - t0, mesh=mesh2)
