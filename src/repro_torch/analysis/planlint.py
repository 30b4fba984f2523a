"""Static plan verifier over the port (port of
``repro/analysis/planlint.py``): trace every (technique x placement x
schedule x wire_dtype) the registry can express — no card.

The whole launch path is re-derived device-free: meta tensors stand in
for ``jax.eval_shape`` — the model from ``models.registry.build_model``
on the meta device with its kernels on (each wrapper takes its
kernel's shape rule there, as ``launch.dryrun`` traces it), AdamW's
state from ``init_adamw`` of those params and the batch from
``input_specs(..., abstract=True)`` — ``core.plans.MeshSpec`` stands in
for the mesh (plans consult only axis names and sizes), and
``PlanSearch`` enumerates exactly the candidate space ``search()``
would score.  What the real launch would build is therefore checked —
not a simplification of it:

  * PLAN001 — ``PLANS`` / ``TECHNIQUE_SPECS`` drift: a technique priced
    but not executable, or vice versa.
  * PLAN002 — sharding consistency: every param / optimizer / batch
    spec a plan emits (a tuple whose entries are ``None``, an axis name
    or a tuple of names) names only mesh axes, never reuses an axis
    within one spec, and divides its dimension exactly (the rule engine
    is supposed to fall back to replication otherwise).
  * PLAN003 — unpartitionable stage splits: ``validate_stages`` must
    accept every searched pipeline placement's ``stage_layers`` for its
    schedule's chunk count.
  * PLAN004 — memory-envelope drift: for every candidate the scorer
    calls feasible, ``technique_state_bytes`` + overhead must fit the
    ``memory_envelope_gb`` the cost model assumes (and the scorer's own
    ``StepCost`` must agree with both exports).
  * PLAN005 — contract of the training step: ``Model.loss`` traced on
    meta tensors yields an fp32 scalar plus scalar metrics, and AdamW
    state mirrors the param tree.

Scenario A is a paper-style two-site slice (2 GPUs per site, so model
axis 1 and 2); scenario B a heterogeneous 3-site line of single-GPU
sites with a 7-layer stack and TFLOP-weighted stage balance — the
non-divisible splits and uneven chunk quotas are exactly where stage
arithmetic breaks first.  Both are the reference's, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis import Finding, PassResult
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.costmodel import (ALL_TECHNIQUES, SCHEDULES,
                                        TECHNIQUE_SPECS, WIRE_DTYPES,
                                        Workload, memory_envelope_gb,
                                        technique_state_bytes)
from repro_torch.core.pipeline import validate_stages
from repro_torch.core.plans import MeshSpec, PLANS, get_plan
from repro_torch.core.search import PlanSearch
from repro_torch.core.topology import Link, Site, line
from repro_torch.launch.mesh import topology_mesh_spec
from repro_torch.models.registry import build_model, input_specs
from repro_torch.optim import init_adamw

_PLANS_FILE = "src/repro_torch/core/plans.py"
_COST_FILE = "src/repro_torch/core/costmodel.py"


@dataclasses.dataclass
class Scenario:
    name: str
    topo: object
    wl: Workload
    model_axes: Tuple[int, ...]
    stage_balance: str = "even"


def _scenarios() -> List[Scenario]:
    cfg_a = dataclasses.replace(get_config("gpt2m").reduced(), n_layers=4)
    topo_a = line("planlint-2site",
                  [Site(("RTX", "RTX"), name="V1"),
                   Site(("T4", "T4"), name="V2")],
                  [Link(20e-3, 3.0)])
    wl_a = Workload(cfg_a, seq_len=32, global_batch=8, steps_per_epoch=2,
                    microbatches=4)
    # heterogeneous line of single-GPU sites, 7 layers: non-divisible
    # stacks + TFLOP-weighted chunk quotas
    cfg_b = dataclasses.replace(get_config("gpt2m").reduced(), n_layers=7)
    topo_b = line("planlint-line3",
                  [Site(("A30",), name="V1"), Site(("T4",), name="V2"),
                   Site(("T4",), name="V3")],
                  [Link(20e-3, 3.0), Link(5e-3, 10.0)])
    wl_b = Workload(cfg_b, seq_len=32, global_batch=8, steps_per_epoch=2,
                    microbatches=4)
    return [Scenario("2site", topo_a, wl_a, (1, 2)),
            Scenario("line3", topo_b, wl_b, (1,), "tflops")]


def check_registry(priced, executable) -> List[Tuple[str, str, str]]:
    """PLAN001 core: (rule-file, direction, message) for each name on
    one side of the priced/executable registries only.  Pure so tests
    can feed drifted fakes."""
    priced, executable = set(priced), set(executable)
    out = []
    for t in sorted(priced - executable):
        out.append((_COST_FILE, "priced-only",
                    f"technique {t!r} is priced by TECHNIQUE_SPECS but "
                    f"has no executable plan in PLANS"))
    for t in sorted(executable - priced):
        out.append((_PLANS_FILE, "executable-only",
                    f"plan {t!r} is executable but TECHNIQUE_SPECS "
                    f"does not price it"))
    return out


def _leaves(tree, is_leaf) -> list:
    """Leaves of nested dicts (keys sorted, as jax orders them), lists
    and NamedTuples, down to ``is_leaf``."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v, is_leaf)]
    return [tree]


def _is_spec(x) -> bool:
    """A spec of the port: a plain tuple of ``None``, axis names and
    tuples of names."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def check_specs(shapes, specs, mesh: MeshSpec,
                what: str) -> List[str]:
    """PLAN002 core: every spec names known axes, never reuses one, and
    divides its dimension.  Pure (shapes + specs + mesh in, problems
    out) so tests can feed deliberately broken specs."""
    problems: List[str] = []
    axis_size = mesh.shape
    flat_shapes = _leaves(shapes, lambda x: isinstance(x, torch.Tensor))
    flat_specs = _leaves(specs, _is_spec)
    if len(flat_shapes) != len(flat_specs):
        return [f"{what}: {len(flat_shapes)} leaves but "
                f"{len(flat_specs)} specs"]
    for leaf, spec in zip(flat_shapes, flat_specs):
        if not _is_spec(spec):
            problems.append(f"{what}: non-spec leaf {spec!r}")
            continue
        used: List[str] = []
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            size = 1
            for a in axes:
                if a not in axis_size:
                    problems.append(
                        f"{what}: spec {spec} names axis {a!r} not on "
                        f"mesh {mesh.axes}")
                    continue
                used.append(a)
                size *= axis_size[a]
            if dim >= len(leaf.shape):
                problems.append(
                    f"{what}: spec {spec} has more entries than leaf "
                    f"rank {len(leaf.shape)}")
            elif size > 1 and leaf.shape[dim] % size != 0:
                problems.append(
                    f"{what}: dim {dim} of shape {tuple(leaf.shape)} "
                    f"not divisible by {size} ({spec} on {mesh.axes})")
        if len(used) != len(set(used)):
            problems.append(
                f"{what}: spec {spec} reuses a mesh axis")
    return problems


def _abstract_state(model, wl: Workload):
    params = model.init(torch.Generator(), device="meta")
    opt = init_adamw(params)
    shape = ShapeConfig("planlint", wl.seq_len, wl.global_batch, "train")
    batch = input_specs(model.cfg, shape, abstract=True)
    return params, opt, batch


def _check_contract(model, params, opt, batch, where: str) -> List[str]:
    """PLAN005: the training-step contract, traced on meta tensors."""
    problems = []
    with torch.no_grad():
        loss, metrics = model.loss(params, batch, remat=False)
    if loss.shape != () or loss.dtype != torch.float32:
        problems.append(f"{where}: loss traces to "
                        f"{loss.dtype}{tuple(loss.shape)}, expected float32 "
                        f"scalar")
    for k, v in metrics.items():
        if v.shape != ():
            problems.append(f"{where}: metric {k!r} traces to shape "
                            f"{tuple(v.shape)}, expected scalar")
    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    p_leaves = _leaves(params, is_t)
    for name, tree in (("m", opt.m), ("v", opt.v)):
        o_leaves = _leaves(tree, is_t)
        if [(l.shape, l.dtype) for l in o_leaves] != \
                [(l.shape, l.dtype) for l in p_leaves]:
            problems.append(f"{where}: AdamW {name} tree does not "
                            f"mirror the param tree")
    return problems


def _candidate_mesh(plan, place, topo, sites,
                    model_axis: int) -> Optional[MeshSpec]:
    shape, axes = topology_mesh_spec(topo, sites, model=model_axis)
    if plan.pipeline:
        # pipeline_mesh: the stage axis absorbs the pod axis (one pod
        # block per placed site)
        return MeshSpec.of((place.n_stages,) + shape[1:],
                           ("stage",) + axes[1:])
    return MeshSpec.of(shape, axes)


def run(root: str) -> PassResult:
    res = PassResult("planlint")

    def add(rule: str, file: str, line_no: int, msg: str,
            severity: str = "error") -> None:
        res.findings.append(Finding(rule, severity, file, line_no, msg))

    # PLAN001: registry drift
    for file, _, msg in check_registry(TECHNIQUE_SPECS, PLANS):
        add("PLAN001", file, 1, msg)

    n_cand = n_spec_checks = n_split_checks = 0
    for scen in _scenarios():
        model = build_model(scen.wl.cfg, device="meta")
        params, opt, batch = _abstract_state(model, scen.wl)
        for msg in _check_contract(model, params, opt, batch, scen.name):
            add("PLAN005", _COST_FILE, 1, msg)

        search = PlanSearch(scen.wl, scen.topo,
                            techniques=ALL_TECHNIQUES,
                            schedules=SCHEDULES,
                            wire_dtypes=WIRE_DTYPES,
                            stage_balance=scen.stage_balance)
        seen_spec: set = set()
        seen_split: set = set()
        for sc in search.search(prune=False):
            cand = sc.candidate
            n_cand += 1
            place = search.placement(cand)
            plan = get_plan(cand.technique)
            cost = search.step_cost(cand)

            # PLAN004: envelope / feasibility consistency
            env = memory_envelope_gb(scen.topo, cand.sites)
            if abs(cost.mem_available_gb - env) > 1e-9:
                add("PLAN004", _COST_FILE, 1,
                    f"{scen.name} {cand.key}: StepCost envelope "
                    f"{cost.mem_available_gb} != memory_envelope_gb "
                    f"{env}")
            if sc.tflops:
                state_gb = technique_state_bytes(
                    cand.technique, scen.wl, scen.topo,
                    cand.sites) / 1e9
                if state_gb + scen.wl.OVERHEAD_GB > env + 1e-6:
                    add("PLAN004", _COST_FILE, 1,
                        f"{scen.name} {cand.key}: feasible per the "
                        f"scorer but technique_state_bytes "
                        f"({state_gb:.2f} GB) + overhead exceeds the "
                        f"{env:.2f} GB site envelope")
                if not cost.fits:
                    add("PLAN004", _COST_FILE, 1,
                        f"{scen.name} {cand.key}: scorer returned "
                        f"TFLOP/s for a placement whose StepCost "
                        f"does not fit")

            # PLAN003: stage split must partition the stack
            if plan.pipeline:
                key = (cand.sites, cand.schedule, place.stage_layers)
                if key not in seen_split:
                    seen_split.add(key)
                    n_split_checks += 1
                    try:
                        validate_stages(scen.wl.cfg, params["layers"],
                                        place.n_stages,
                                        place.stage_layers,
                                        schedule=place.schedule)
                    except ValueError as e:
                        add("PLAN003", _PLANS_FILE, 1,
                            f"{scen.name} {cand.key}: searched "
                            f"placement rejected by validate_stages: "
                            f"{e}")

            # PLAN002: shardings for every mesh variant
            for mv in scen.model_axes:
                key = (cand.technique, cand.sites, cand.schedule, mv)
                if key in seen_spec:
                    continue
                seen_spec.add(key)
                mesh = _candidate_mesh(plan, place, scen.topo,
                                       cand.sites, mv)
                trees = (
                    ("params", params,
                     plan.param_specs(params, scen.wl.cfg, mesh)),
                    ("opt", params,
                     plan.opt_specs(params, scen.wl.cfg, mesh)),
                    ("batch", batch, plan.batch_spec(batch, mesh)),
                )
                for what, shapes, specs in trees:
                    n_spec_checks += 1
                    for msg in check_specs(
                            shapes, specs, mesh,
                            f"{scen.name} {cand.key} model={mv} "
                            f"{what}"):
                        add("PLAN002", _PLANS_FILE, 1, msg)
    res.stats = {"candidates": n_cand, "spec_trees": n_spec_checks,
                 "stage_splits": n_split_checks,
                 "techniques": len(TECHNIQUE_SPECS)}
    return res
