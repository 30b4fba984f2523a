"""Cross-plan checkpoint resharding: restore any saved run onto any plan
(port of ``repro/train/reshard.py``).

``train/checkpoint.py`` saves the one-device layout (every leaf whole,
the layer stack in logical order), so a checkpoint is already
layout-independent, and a reshard between two (technique x placement x
stage_layers) layouts decomposes as in the reference:

  * **re-placement**: the destination step's layout on its mesh
    (``plan_state_layout``: the plan's specs, the specs the step holds
    AdamW's moments by, and for a pipeline the stage's rows), and each
    leaf cut to this rank's block on the host, only that block moved to
    the device (``reshard_checkpoint``), the moments leaf for leaf;
  * **re-staging**: ``stage_view`` / ``unstage_view`` / ``restage``
    apply ``core.pipeline.stage_gather_index`` outside the runtime, the
    reference's padded stage-major view (a chunk padded to the longest
    by repeating its last layer).  The port's pipeline holds a stage's
    rows without padding (``core.pipeline.stage_rows``): the view's
    valid rows.

``reshard_state`` is the host-side reference re-placement the checks
hold ``reshard_checkpoint`` to: it takes a stage's valid rows of
``stage_view`` and cuts blocks with numpy, sharing no code with the
steps' ``shard_params``.  Nothing is recomputed, cast (unless
``allow_cast``) or renormalized.

The hybrid family's stack is its groups: a split is checked against
the stack's length, as ``core.steps.PipelineStep`` checks it (the
reference checks ``cfg.n_layers``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.costmodel import parse_schedule
from repro_torch.core.pipeline import (held_rows, pipeline_split,
                                       stage_gather_index, stage_rows)
from repro_torch.core.plans import STAGE_AXIS, Placement, Plan
from repro_torch.core.sharding import slice_leaf, tree_map_with_path
from repro_torch.core.steps import stage_local_specs
from repro_torch.optim import AdamWState
from repro_torch.optim.adamw import tree_map
from repro_torch.train.checkpoint import load_manifest, read_flat


# --------------------------------------------------------------------- #
# stage re-slicing: canonical stack <-> padded stage-major views
# --------------------------------------------------------------------- #

def normalized_stage_layers(n_layers: int,
                            placement: Placement) -> Tuple[int, ...]:
    """The per-chunk layer split a pipeline placement runs: its explicit
    ``stage_layers`` when present, else the even split — which must
    divide.  The reference's function, with its messages; the port's
    steps and ``reshard_checkpoint`` check a split against the stack
    with ``core.pipeline.pipeline_split``.

    Raises:
        ValueError: no explicit split and ``n_layers`` does not divide
            into the placement's chunk count.
    """
    _, virt = parse_schedule(placement.schedule)
    n_chunks = placement.n_stages * virt
    if placement.stage_layers is not None:
        return tuple(int(l) for l in placement.stage_layers)
    if n_layers % n_chunks != 0:
        raise ValueError(
            f"{n_layers} layers do not divide into {n_chunks} chunks "
            f"({placement.n_stages} stages, {placement.schedule}) and the "
            f"placement carries no explicit stage_layers")
    return (n_layers // n_chunks,) * n_chunks


def _take(leaf, rows: np.ndarray):
    """Rows ``rows`` of a leaf's first axis: a tensor stays a tensor on
    its device, anything else becomes a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.index_select(0, torch.as_tensor(
            rows, dtype=torch.long, device=leaf.device))
    return np.take(np.asarray(leaf), rows, axis=0)


def stage_view(stack, stage_layers, n_stages: int,
               schedule: str = "gpipe") -> Tuple[Any, np.ndarray]:
    """A layout's padded stage-major view of a canonical layer stack
    (nested dicts of tensors or numpy arrays): chunk ``c = k * n_stages
    + s`` of stage s lands back to back, padded to the longest chunk by
    repeating its last layer.

    Returns:
        ``(staged, layer_valid)``: the gathered tree with leading axis
        ``n_stages * virt * max(stage_layers)`` and the boolean validity
        mask over that axis (False = padding slot).
    """
    _, virt = parse_schedule(schedule)
    idx, valid = stage_gather_index(stage_layers, n_stages, virt)
    return tree_map(lambda leaf: _take(leaf, idx), stack), valid


def unstage_view(staged, stage_layers, n_stages: int,
                 schedule: str = "gpipe"):
    """Invert ``stage_view``: drop padding slots and reorder the chunks
    back into logical layer order, recovering the canonical stack
    bit-exactly."""
    _, virt = parse_schedule(schedule)
    split = tuple(int(l) for l in stage_layers)
    if len(split) != n_stages * virt:
        raise ValueError(f"split {split} has {len(split)} entries for "
                         f"{n_stages} stages x {virt} virtual")
    max_l = max(split)
    # position of chunk c inside the stage-major view
    chunk_of = [k * n_stages + s
                for s in range(n_stages) for k in range(virt)]
    pos = {c: p for p, c in enumerate(chunk_of)}
    rows = np.concatenate([
        pos[c] * max_l + np.arange(split[c])
        for c in range(len(split))]).astype(np.int32)

    def un(leaf):
        if leaf.shape[0] != n_stages * virt * max_l:
            raise ValueError(
                f"staged leaf has leading axis {leaf.shape[0]}, expected "
                f"{n_stages * virt * max_l} for split {split}")
        return _take(leaf, rows)

    return tree_map(un, staged)


def restage(staged, src_layers, src_stages: int, dst_layers,
            dst_stages: int, *, src_schedule: str = "gpipe",
            dst_schedule: str = "gpipe"):
    """Map one pipeline layout's staged view directly into another's: the
    per-stage layer re-slice of a stage-count, split or schedule change.

    Returns:
        ``(staged_dst, layer_valid_dst)`` as from ``stage_view``.
    """
    canon = unstage_view(staged, src_layers, src_stages,
                         schedule=src_schedule)
    return stage_view(canon, dst_layers, dst_stages, schedule=dst_schedule)


# --------------------------------------------------------------------- #
# re-placement: host checkpoint -> any plan's layout on this rank
# --------------------------------------------------------------------- #

def state_templates(model) -> Tuple[Any, AdamWState]:
    """Shape and dtype templates (tensors on the ``meta`` device) of a
    model's params and AdamW state, allocating neither."""
    p_like = model.init(torch.Generator(), device="meta")

    def like(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return p_like, AdamWState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        m=tree_map(like, p_like), v=tree_map(like, p_like))


@dataclass(frozen=True)
class StateLayout:
    """Where a plan's step holds this rank's state on a mesh.

    Attributes:
        param_specs: the plan's specs (the reference's shardings).
        local_specs: the specs the step cuts the params by (a pipeline's
            stack dims not cut over the stage axis).
        opt_specs: the specs the step cuts AdamW's moments by.
        rows: a pipeline stage's rows of the stack (its chunks back to
            back, ``core.pipeline.stage_rows``); None for a flat plan.
        split: a pipeline's per-chunk split; None for a flat plan.
        schedule: a pipeline's tick-order schedule.
    """
    param_specs: Any
    local_specs: Any
    opt_specs: Any
    rows: Optional[np.ndarray] = None
    split: Optional[Tuple[int, ...]] = None
    schedule: str = "gpipe"


def check_pipeline_placement(cfg: ModelConfig, params_like,
                             placement: Optional[Placement], mesh=None
                             ) -> Tuple[int, ...]:
    """The split a pipeline placement runs on the model's stack (layers,
    or the hybrid family's groups), checked before anything is restored.

    Raises:
        ValueError: no placement, a stage count other than the mesh's, or
            a split that does not partition the stack.
    """
    if placement is None:
        raise ValueError("pipeline destination needs the Placement "
                         "(stage count + stage_layers)")
    if mesh is not None and placement.n_stages != mesh.shape[STAGE_AXIS]:
        raise ValueError(f"placement has {placement.n_stages} stages, the "
                         f"mesh {mesh.shape[STAGE_AXIS]}")
    return pipeline_split(cfg, params_like["layers"], placement.n_stages,
                          placement.stage_layers, placement.schedule)


def plan_state_layout(plan: Plan, params_like, cfg: ModelConfig, mesh, *,
                      placement: Optional[Placement] = None) -> StateLayout:
    """The destination step's layout on this rank of ``mesh``: what
    ``core.steps.PlanStep`` (``param_specs``, ``opt_specs``) or, for a
    pipeline plan, ``core.steps.PipelineStep`` (its local specs and
    rows, for params and moments alike) hold."""
    p_specs = plan.param_specs(params_like, cfg, mesh)
    if not plan.pipeline:
        return StateLayout(p_specs, p_specs,
                           plan.opt_specs(params_like, cfg, mesh))
    split = check_pipeline_placement(cfg, params_like, placement, mesh)
    _, virt = parse_schedule(placement.schedule)
    local = stage_local_specs(p_specs)
    rows = stage_rows(split, mesh.shape[STAGE_AXIS], virt,
                      mesh.coord[STAGE_AXIS])
    return StateLayout(p_specs, local, local, rows, split,
                       placement.schedule)


def _host_block(arr: np.ndarray, spec, mesh) -> np.ndarray:
    """This rank's block of a host array, by ``numpy.split``."""
    for dim, e in enumerate(spec):
        if e is None:
            continue
        n, i = 1, 0
        for a in (e if isinstance(e, tuple) else (e,)):
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + mesh.coord[a]
        arr = np.split(arr, n, axis=dim)[i]
    return arr


def _numpy(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
        else np.asarray(leaf)


def reshard_state(params_host, opt_host, plan: Plan, cfg: ModelConfig,
                  mesh, *, placement: Optional[Placement] = None,
                  device="cuda") -> Tuple[Any, Optional[AdamWState]]:
    """Place one-device host (params, opt) trees onto a plan's layout on
    this rank: the host-side reference re-placement.

    For a pipeline this stage's valid rows of ``stage_view`` come first;
    then each leaf is cut to this rank's block by the layout's specs with
    numpy and moved to ``device``.  No value changes, the moments map
    leaf for leaf.
    """
    layout = plan_state_layout(plan, params_host, cfg, mesh,
                               placement=placement)
    staged_rows = None
    if layout.rows is not None:
        S = mesh.shape[STAGE_AXIS]
        _, virt = parse_schedule(layout.schedule)
        per = virt * max(layout.split)
        sl = slice(mesh.coord[STAGE_AXIS] * per,
                   (mesh.coord[STAGE_AXIS] + 1) * per)

        def staged_rows(stack):
            staged, valid = stage_view(tree_map(_numpy, stack),
                                       layout.split, S, layout.schedule)
            return tree_map(lambda a: a[sl][valid[sl]], staged)

    def place(tree, specs):
        tree = dict(tree)
        if staged_rows is not None:
            tree["layers"] = staged_rows(tree["layers"])
            if "encoder" in tree:
                # the first stage holds the encoder's stack whole, the
                # others none of it (``core.pipeline.held_rows``)
                n = None if mesh.coord[STAGE_AXIS] == 0 else 0
                tree["encoder"] = dict(tree["encoder"], layers=tree_map(
                    lambda a: _numpy(a)[:n], tree["encoder"]["layers"]))
        return tree_map_with_path(
            lambda _, leaf, spec: torch.from_numpy(np.ascontiguousarray(
                _host_block(_numpy(leaf), spec, mesh))).to(device),
            tree, specs)

    params = place(params_host, layout.local_specs)
    if opt_host is None:
        return params, None
    return params, AdamWState(
        step=torch.as_tensor(_numpy(opt_host.step)).to(device),
        m=place(opt_host.m, layout.opt_specs),
        v=place(opt_host.v, layout.opt_specs))


def _blocks(path, flat, prefix, like, specs, layout, mesh, device,
            allow_cast):
    """This rank's blocks of the checkpoint's ``prefix`` leaves (``flat``,
    by key), in the step's layout: a pipeline stage's rows, then the
    step's cut, each block alone moved to ``device``."""
    stage = None if layout.rows is None else mesh.coord[STAGE_AXIS]

    def one(key, leaf, spec):
        full = f"{prefix}/{key}" if prefix else key
        if full not in flat:
            raise ValueError(f"{full}: not in checkpoint {path}")
        arr = flat.pop(full)
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{full}: ckpt {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        t = torch.from_numpy(arr)
        if t.dtype != leaf.dtype and not allow_cast:
            raise ValueError(
                f"{full}: checkpoint dtype {t.dtype} != template "
                f"{leaf.dtype}; a silent cast would lose master-weight "
                f"precision — pass allow_cast=True to convert deliberately")
        rows = None if stage is None else \
            held_rows(key, layout.rows, stage, t.shape[0])
        if rows is not None:
            t = t.index_select(0, torch.as_tensor(rows, dtype=torch.long))
        return slice_leaf(t, spec, mesh).to(device=device, dtype=leaf.dtype,
                                            copy=True)

    return tree_map_with_path(one, like, specs)


def reshard_checkpoint(path: str, model, plan: Plan, mesh, *,
                       placement: Optional[Placement] = None,
                       allow_cast: bool = False,
                       verify: bool = True) -> Tuple[Any, Any, int]:
    """Restore a checkpoint onto a (possibly different) plan's layout, as
    this rank's blocks on the model's device.

    The integrity-verified restore of the one-device host arrays,
    templates from the model, the destination layout from ``(plan,
    mesh)`` (``plan_state_layout``), every leaf — params and AdamW
    moments alike — cut on the host and only its block moved to the
    device, so no rank holds the whole state on its card.  For a
    pipeline destination ``placement`` is checked first: its
    ``stage_layers`` (or the even split) must partition the model's
    stack, so an impossible re-stage fails here.

    Args:
        path: checkpoint directory.
        model: the ``models.Model`` being restored (shapes, dtypes,
            device, and the config the plan's rules read).
        plan: destination execution plan (``core.plans.PLANS``).
        mesh: destination mesh holding this rank
            (``launch.mesh.placement_mesh``).
        placement: the destination ``core.plans.Placement``; required
            for a pipeline plan.
        allow_cast: restore across a dtype change.
        verify: check every shard's sha256 first.

    Returns:
        ``(params, opt_state, step)`` in the layout ``train(...,
        sharded=True)`` takes: ``PlanStep``'s, or ``PipelineStep``'s
        local one; ``opt_state`` is None when the checkpoint has none.
    """
    cfg = model.cfg
    p_like, o_like = state_templates(model)
    if plan.pipeline:
        check_pipeline_placement(cfg, p_like, placement, mesh)
    if not mesh.holds_me:
        raise ValueError("this rank is not on the destination mesh")
    layout = plan_state_layout(plan, p_like, cfg, mesh, placement=placement)
    manifest = load_manifest(path, verify=verify)
    dev = model.device
    params = _blocks(path, read_flat(path, manifest, "params"), "",
                     p_like, layout.local_specs, layout, mesh, dev,
                     allow_cast)
    opt = None
    if "opt" in manifest["files"]:
        flat = read_flat(path, manifest, "opt")
        if "step" not in flat:
            raise ValueError(f"opt/step: not in checkpoint {path}")
        opt = AdamWState(
            step=torch.from_numpy(flat.pop("step")).to(
                device=dev, dtype=o_like.step.dtype),
            m=_blocks(path, flat, "m", o_like.m, layout.opt_specs, layout,
                      mesh, dev, allow_cast),
            v=_blocks(path, flat, "v", o_like.v, layout.opt_specs, layout,
                      mesh, dev, allow_cast))
    return params, opt, manifest["step"]
