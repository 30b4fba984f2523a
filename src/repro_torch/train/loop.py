"""Training loop on one device (port of ``repro/train/loop.py``).

Reports what the paper measures (§III-B): wall-clock step time and the
achieved model TFLOP/s, 6·N·D over the step time.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.steps import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim import init_adamw
from repro_torch.train.checkpoint import save_checkpoint


@dataclass
class TrainResult:
    """The reference's result, plus the final params and optimizer state
    (the reference's jitted step donates them instead)."""
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
          plan: Optional[str] = None) -> TrainResult:
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
    ``plan`` must be None (one device; ROADMAP queue 1, item 7)."""
    cfg = model.cfg
    step_fn = build_train_step(model, tcfg, plan=plan)
    if params is None:
        params = model.init(torch.Generator(device=model.device)
                            .manual_seed(tcfg.seed))
    if opt_state is None:
        opt_state = init_adamw(params)
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
        if log_every and (i % log_every == 0 or i == steps - 1):
            log_fn(f"step {i:5d} loss {loss:8.4f} "
                   f"ce {float(metrics['ce']):8.4f} "
                   f"gnorm {float(metrics['grad_norm']):7.3f} "
                   f"{dt * 1e3:8.1f} ms "
                   f"{flops / max(dt, 1e-9) / 1e12:6.2f} TFLOP/s")
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, i + 1, params, opt_state)
    result.metrics_last = {k: float(v) for k, v in metrics.items()}
    if ckpt_dir:
        save_checkpoint(ckpt_dir, steps, params, opt_state)
    result.params, result.opt_state = params, opt_state
    return result
