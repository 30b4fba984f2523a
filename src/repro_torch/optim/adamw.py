"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``).

The state mirrors the parameter dict (``m``, ``v`` per leaf, fp32) beside
an int32 step counter, so a later plan can place it leaf by leaf.  The
update is a function of (grads, state, params) returning new tensors, in
the reference's order of operations and in fp32 throughout: clip, then
the moments, then bias correction by ``1 - beta ** step`` taken in fp32
tensors, then decoupled weight decay on every leaf but the ``_NO_DECAY``
ones.  Not ``torch.optim.AdamW``: its clipping and decay mask differ.

Under a plan the update runs on this rank's blocks of the grads, params
and moments, cut by ``specs`` over ``mesh`` (``core.sharding``): the
clipping norm adds each cut leaf's local sum of squares over the axes
that cut it and counts a whole leaf once, so it is the norm of the
whole gradient; every other step is elementwise.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.sharding import all_reduce, spec_axes


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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """The norm of the whole tree; with ``specs``, of the whole tree whose
    blocks the ranks of ``mesh`` hold (one all-reduce for each set of
    axes that cuts some leaf, of those leaves' sums stacked)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if specs is not None:
        by_axes: Dict[Tuple[str, ...], list] = {}
        for i, spec in enumerate(tree_leaves(specs)):
            axes = spec_axes(spec)
            if axes:
                by_axes.setdefault(tuple(sorted(
                    axes, key=mesh.axis_names.index)), []).append(i)
        for axes, idx in by_axes.items():
            sums = all_reduce(torch.stack([leaves[i] for i in idx]),
                              mesh.group(axes))
            for j, i in enumerate(idx):
                leaves[i] = sums[j]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    norm = global_norm(grads, specs, mesh)
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
                 lr: torch.Tensor, *, specs=None, mesh=None,
                 donate: bool = False
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, stats).
    ``specs``/``mesh``: the leaves are blocks cut by ``specs``.

    Leaf by leaf: each leaf's clipped gradient and moments are made and
    dropped before the next, so no whole-tree temporary is held.
    ``donate`` (the reference's jitted step donates its params and
    state): the new values are written into ``params``, ``state.m`` and
    ``state.v`` in place, the same bits, and those trees are returned,
    so a step holds one copy of each."""
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    step = state.step + 1
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def one(path, p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        del g
        mh, vh = m_new / c1, v_new / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        del mh, vh
        if _decay_mask(path):
            delta = delta + cfg.weight_decay * p.float()
        p_new = (p.float() - lr * delta).to(p.dtype)
        if not donate:
            return p_new, m_new, v_new
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    def walk(p, g, m, v, path=""):
        if isinstance(p, dict):
            out = {k: walk(p[k], g[k], m[k], v[k], k) for k in p}
            return tuple({k: o[j] for k, o in out.items()} for j in range(3))
        return one(path, p, g, m, v)

    with torch.no_grad():
        new_params, new_m, new_v = walk(params, grads, state.m, state.v)
    return new_params, AdamWState(step=step, m=new_m, v=new_v), {
        "grad_norm": gnorm, "lr": lr}
