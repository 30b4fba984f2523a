"""The train step for one device (port of the non-pipeline, one-device
case of ``repro/core/steps.py:build_train_step``).

``build_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)`` with the reference's metric keys.  Gradients are
taken with ``torch.autograd.grad`` on detached copies of the fp32
leaves, so the caller's params are left as they were; ``grad_accum > 1``
runs the batch as sequential microbatches and sums their gradients in
fp32, as the reference's ``lax.scan`` does.  The reference's execution
plans (data, zero2, shard, pipeshard, ...) shard this step over a mesh;
the port has none yet (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.model import Model
from repro_torch.optim import adamw_update, lr_at
from repro_torch.optim.adamw import tree_leaves, tree_map

METRIC_KEYS = ("ce", "aux", "zloss", "accuracy", "tokens")


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``, all detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def build_train_step(model: Model, tcfg: TrainConfig, *,
                     plan: Optional[str] = None) -> Callable:
    """The one-device train step.  ``plan`` must be None: any execution
    plan raises ``NotImplementedError``."""
    if plan is not None:
        raise NotImplementedError(
            f"plan {plan!r}: the port trains on one device; execution "
            f"plans on torch.distributed are ROADMAP queue 1, item 7")
    loss_fn = partial(model.loss, remat=tcfg.remat)

    def grad_fn(params, batch):
        A = tcfg.grad_accum
        if A <= 1:
            return value_and_grad(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into grad_accum={A} "
                             f"microbatches")
        b = B // A
        g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        zero = torch.zeros((), dtype=torch.float32, device=model.device)
        loss_sum, m_sum = zero, {k: zero for k in METRIC_KEYS}
        for a in range(A):
            mb = {k: v[a * b:(a + 1) * b] for k, v in batch.items()}
            loss, metrics, g = value_and_grad(loss_fn, params, mb)
            g_sum = tree_map(lambda acc, gg: acc + gg.float(), g_sum, g)
            loss_sum = loss_sum + loss
            m_sum = {k: m_sum[k] + metrics[k] for k in METRIC_KEYS}
        metrics = {k: v / A for k, v in m_sum.items()}
        metrics["tokens"] = metrics["tokens"] * A
        return loss_sum / A, metrics, tree_map(lambda g: g / A, g_sum)

    def step(params, opt_state, batch) -> tuple:
        loss, metrics, grads = grad_fn(params, batch)
        lr = lr_at(opt_state.step, tcfg)
        new_params, new_opt, stats = adamw_update(grads, opt_state, params,
                                                  tcfg, lr)
        metrics: Dict[str, torch.Tensor] = dict(metrics, loss=loss, **stats)
        return new_params, new_opt, metrics

    return step
