"""Training loop (port of ``repro/train/loop.py``): on one device, or
on every rank of a mesh under an execution plan.

Reports what the paper measures (§III-B): wall-clock step time and the
achieved model TFLOP/s, 6·N·D over the step time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.steps import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim import init_adamw
from repro_torch.train.checkpoint import save_checkpoint


@dataclass
class TrainResult:
    """The reference's result, plus the final params and optimizer state
    (the reference's jitted step donates them instead): under a plan,
    this rank's blocks of them."""
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)
    metrics_last: Dict[str, float] = field(default_factory=dict)
    params: Any = None
    opt_state: Any = None

    @property
    def avg_step_time(self) -> float:
        times = self.step_times[1:] or self.step_times  # drop the first
        return float(np.mean(times)) if times else float("nan")

    def tflops(self, model_flops_per_step: float) -> float:
        t = self.avg_step_time
        return model_flops_per_step / t / 1e12 if t > 0 else 0.0


def model_flops_per_step(cfg: ModelConfig, tokens_per_step: int) -> float:
    """6·N_active·D — the paper's 'training performance' numerator."""
    return 6.0 * cfg.active_param_count() * tokens_per_step


def train(model: Model, tcfg: TrainConfig, loader, *, steps: int,
          params=None, opt_state=None, log_every: int = 10,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
          start_step: int = 0,
          on_step_failure: Optional[Callable[[int], None]] = None,
          log_fn: Callable[[str], None] = print,
          plan=None, mesh=None, stage_layers=None,
          schedule: str = "gpipe", donate: bool = False) -> TrainResult:
    """Train ``model`` on ``loader.batch_at(i)`` for steps ``start_step``
    to ``steps - 1`` on the model's device.  Fresh params come from
    ``tcfg.seed``.

    ``start_step`` resumes mid-run against the same deterministic batch
    sequence and absolute step numbers, so a restored checkpoint
    continues where the original run would have been.
    ``on_step_failure`` is called with the absolute step before each step;
    an exception it raises leaves ``train`` with the partial
    ``TrainResult`` as its ``result`` attribute.  ``ckpt_every`` saves
    after every such number of steps, and ``ckpt_dir`` also at the end.

    ``plan`` (a ``core.plans.PLANS`` name or ``Plan``) runs every step
    under that plan on ``mesh`` (``launch.mesh.make_host_mesh``); every
    rank of the mesh calls ``train`` alike.  ``params`` and
    ``opt_state``, when given, are in the one-device layout, and each
    rank keeps its blocks; each step takes this rank's slice of
    ``loader.batch_at(i)`` by its place on the batch axes.  Checkpoints
    are gathered into the one-device layout and written by rank 0, so
    any plan, or one device, restores them; only rank 0 logs.

    ``stage_layers`` and ``schedule`` (pipeline plans, the reference's
    keywords): a searched ``Placement``'s per-chunk layer split and
    tick-order schedule, on a staged mesh
    (``launch.mesh.make_pipeline_mesh``); ``tcfg.microbatches`` cuts
    each rank's batch.

    ``donate``: each step updates the params and optimizer state in
    place (``core.steps.build_train_step``), so a step holds one copy of
    them; the ``params`` and ``opt_state`` given (at a world of one under
    a plan, the same tensors) are overwritten."""
    cfg = model.cfg
    step_fn = build_train_step(model, tcfg, plan=plan, mesh=mesh,
                               stage_layers=stage_layers, schedule=schedule,
                               donate=donate)
    if params is None:
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(tcfg.seed))
    if plan is None:
        main = True
        if opt_state is None:
            opt_state = init_adamw(params)
    else:
        main = dist.get_rank() == 0
        params = step_fn.shard_params(params)
        opt_state = step_fn.init_opt_state() if opt_state is None \
            else step_fn.shard_opt_state(opt_state)

    def save(step: int) -> None:
        if plan is None:
            save_checkpoint(ckpt_dir, step, params, opt_state)
            return
        full_p = step_fn.gather_params(params)
        full_o = step_fn.gather_opt_state(opt_state)
        if main:
            save_checkpoint(ckpt_dir, step, full_p, full_o)
        dist.barrier()

    first = loader.batch_at(start_step)
    flops = model_flops_per_step(
        cfg, first["tokens"].shape[0] * first["tokens"].shape[1]
        * loader.n_shards)
    result = TrainResult()
    metrics: Dict[str, Any] = {}
    for i in range(start_step, steps):
        if on_step_failure is not None:
            try:
                on_step_failure(i)
            except BaseException as e:
                e.result = result            # partial losses/step times
                raise
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in loader.batch_at(i).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        # the copy to the host waits for everything the step enqueued
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        result.losses.append(loss)
        result.step_times.append(dt)
        if main and log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:5d} loss {loss:8.4f} "
                   f"ce {float(metrics['ce']):8.4f} "
                   f"gnorm {float(metrics['grad_norm']):7.3f} "
                   f"{dt * 1e3:8.1f} ms "
                   f"{flops / max(dt, 1e-9) / 1e12:6.2f} TFLOP/s")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save(i + 1)
    result.metrics_last = {k: float(v) for k, v in metrics.items()}
    if ckpt_dir:
        save(steps)
    result.params, result.opt_state = params, opt_state
    return result
