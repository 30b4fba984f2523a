"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The state mirrors the parameter dict (``m``, ``v`` per leaf, fp32) beside
an int32 step counter, so a later plan can place it leaf by leaf.  The
update is a function of (grads, state, params) returning new tensors, in
the reference's order of operations and in fp32 throughout: clip, then
the moments, then bias correction by ``1 - beta ** step`` taken in fp32
tensors, then decoupled weight decay on every leaf but the ``_NO_DECAY``
ones.  Not ``torch.optim.AdamW``: its clipping and decay mask differ.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor     # scalar int32
    m: Any                 # first moment  (params-shaped, fp32)
    v: Any                 # second moment (params-shaped, fp32)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of tensors (and of ``rest``,
    dicts of the same structure); returns the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_adamw(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


_NO_DECAY = ("scale", "bias", "gates", "dt_bias", "A_log", "D", "norm_scale",
             "q_norm", "kv_norm")


def _decay_mask(key: str) -> bool:
    """Decay a leaf unless its last key is a ``_NO_DECAY`` name or holds
    "norm"; ``key`` is the leaf's last key or its ``/``-joined path."""
    last = key.split("/")[-1]
    return last not in _NO_DECAY and "norm" not in last


def adamw_update(grads, state: AdamWState, params, cfg: TrainConfig,
                 lr: torch.Tensor) -> Tuple[Any, AdamWState,
                                            Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, stats)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.m, grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                     state.v, grads)

    def upd(tree, m_tree, v_tree, path=""):
        if isinstance(tree, dict):
            return {k: upd(tree[k], m_tree[k], v_tree[k], k) for k in tree}
        p, mh, vh = tree, m_tree / c1, v_tree / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    with torch.no_grad():
        new_params = upd(params, new_m, new_v)
    return new_params, AdamWState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
