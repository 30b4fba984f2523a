"""Dry run of the port: price every (architecture × input shape × plan)
step on the reference's production meshes without a card (the port's
counterpart of ``repro/launch/dryrun.py``).

For each combination this builds, on the meta device (shapes, no
storage), the params (``Model.init``), AdamW's state for ``train_4k``,
the cache for the serving shapes (``long_500k`` with the sliding window,
as the reference sets it) and the batch (``models.registry
.input_specs``), and calls the port's step for the plan on one rank of a
fake world of 256 ranks (the 16 x 16 mesh; 512 and 2 x 16 x 16 with
``--multi-pod``): the train step (``core.steps.build_train_step``:
``PlanStep``, ``PipelineStep``) for ``train_4k``, ``serve.steps``'
prefill for ``prefill_32k`` and one decode token against a cache of
``seq_len`` for the decode shapes, under ``serve.steps.ServePlan``.  The
step runs inside ``MemTracker`` (its peak on the meta device, split by
its categories) and a ``launch.collective_trace.CollectiveTrace`` (the
collectives it issues), and the record carries the roofline
(``launch.roofline``) with the H100's constants.

Where the reference lowers and compiles, the port runs its eager step on
meta tensors: every kernel wrapper takes its kernel's shape rule there
(``kernels/ops.py``: what the CUDA path allocates, no launch), so the
peak is that of the path the card runs.  Whether a training step goes
through the kernels is the launchers' decision
(``models.trains_through_kernels``): the families whose kernels have no
backward train through the plain versions, on meta as on the card (the
SSM and hybrid families' per-token scans are Python loops over the
sequence: those traces take minutes).  Under pipeshard (two stages
carved out of pod x data) one rank of each stage is traced and the
largest peak is reported: a roofline is per device, and the stages
differ.

Multi-head Latent Attention and the encoder-decoder run on one device
only (``core.steps.plan_refusal``), so under a plan their records say
``"status": "not_ported"`` with the ROADMAP item, beside the reference's
own skips (``skip_reason``); so does a serving shape whose cache the
plan's runtime refuses (``serve.steps.ServePlan.cache_refusal``: a batch
as large as the stack is deep, ROADMAP queue 3).

    python -m repro_torch.launch.dryrun --arch gpt2m --shape train_4k

runs on the host (no card); the last line is the reference's short JSON
("status": "fail" with the error, and exit 1, where the port's step
raised, as the reference's does where a lowering fails).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from typing import Dict, Optional, Sequence

AXES = ("pod", "data", "model")
STAGES = 2          # pipeshard: stages carved out of pod x data


def skip_reason(cfg, shape) -> str:
    """Documented skips (DESIGN.md §4)."""
    if shape.name == "long_500k":
        if cfg.family == "encdec":
            return ("whisper-small: full-attention enc-dec decoder; 500k-token "
                    "audio transcripts out of scope (DESIGN.md §4)")
        if not cfg.supports_long_context:
            return f"{cfg.name}: no sub-quadratic attention variant"
    return ""


def decode_window(cfg, shape) -> int:
    """The cache's ring for a decode shape: the sliding window for
    ``long_500k``, as the reference sets it; 0 (the whole sequence)
    else."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return cfg.sliding_window
    return 0


def _bytes(tree) -> int:
    """Bytes of the tensors in a tree of dicts, lists and tuples."""
    import torch
    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def build_step(model, plan, mesh, cfg, shape, tcfg):
    """(step fn, its args on the meta device, the analytic cost, the
    state's bytes by part).  ``plan`` None: one device, no mesh.  A
    string where the serving plan has no cache layout for the shape: the
    runtime's refusal (``ServePlan.cache_refusal``)."""
    import torch

    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.analytic import analytic_cost, plan_degrees
    from repro_torch.models.registry import input_specs
    from repro_torch.optim import init_adamw
    from repro_torch.serve.steps import ServePlan, prefill_step, serve_step

    full = model.init(torch.Generator(), device="meta")
    batch = input_specs(cfg, shape)
    n_dev = mesh.grid.size if mesh is not None else 1
    dp, tp, zdeg = plan_degrees(plan, mesh, shape.global_batch) \
        if plan is not None else (1, 1, 1)

    if shape.kind == "train":
        if plan is None:
            step = build_train_step(model, tcfg)
            params, opt = full, init_adamw(full)
        else:
            step = build_train_step(model, tcfg, plan=plan, mesh=mesh)
            params, opt = step.shard_params(full), step.init_opt_state()
        args = (params, opt, batch)
        parts = {"params": params, "opt_state": opt, "batch": batch}
        cost = analytic_cost(cfg, shape, n_devices=n_dev, dp=dp, tp=tp,
                             zero_deg=zdeg, remat=tcfg.remat)
        return step, args, cost, {k: _bytes(v) for k, v in parts.items()}

    window = decode_window(cfg, shape) if shape.kind == "decode" else 0
    sp = None
    if plan is not None:
        sp = ServePlan(model, plan, mesh, max_len=shape.seq_len,
                       window=window)
        refused = sp.cache_refusal(shape.global_batch)
        if refused is not None:
            return str(refused)
        params = sp.shard_params(full)
        cache = sp.init_cache(shape.global_batch)
    else:
        params = full
        cache = model.init_cache(shape.global_batch, shape.seq_len,
                                 window=window)
    if shape.kind == "prefill":
        def step(params, batch, cache):
            return prefill_step(model, params, batch, cache, plan=sp)
        args = (params, batch, cache)
        cost = analytic_cost(cfg, shape, n_devices=n_dev, dp=dp, tp=tp)
    else:
        def step(params, cache, tokens):
            return serve_step(model, params, cache, tokens, window=window,
                              plan=sp)
        args = (params, cache, batch["tokens"])
        cost = analytic_cost(cfg, shape, n_devices=n_dev, dp=dp, tp=tp,
                             window=window)
    parts = {"params": params, "cache": cache, "batch": batch}
    return step, args, cost, {k: _bytes(v) for k, v in parts.items()}


def trace(step, args) -> Dict:
    """Run ``step(*args)`` on meta tensors inside ``MemTracker`` and a
    ``CollectiveTrace``: its collectives, its peak (the args counted
    from the start, as the card holds them) split by the tracker's
    categories, and the seconds the trace took."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch.collective_trace import CollectiveTrace
    mt = MemTracker()
    mt.track_external(*args)
    t0 = time.perf_counter()
    with mt, CollectiveTrace() as ct:
        step(*args)
    seconds = time.perf_counter() - t0
    snap = mt.get_tracker_snapshot("peak")
    split = {str(getattr(k, "value", k)): int(v)
             for dev in snap.values() for k, v in dev.items()}
    return {"records": ct.records, "peak": split.get("Total", 0),
            "split": split, "trace_s": seconds}


def collective_counts(records) -> Dict[str, Dict[str, int]]:
    """Calls and bytes of each kind, as ``sharding.collective_counts``
    counts them."""
    from repro_torch.core.sharding import KINDS
    out = {k: {"calls": 0, "bytes": 0} for k in KINDS}
    for r in records:
        out[r.kind]["calls"] += 1
        out[r.kind]["bytes"] += r.bytes
    return out


def _fake_world(world: int, rank: int) -> None:
    """Join a fake world of ``world`` ranks as ``rank``, leaving the fake
    world joined before; a process in a real world is refused."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import in_fake_world, init_fake_world
    if in_fake_world():
        dist.destroy_process_group()
    elif dist.is_initialized():
        raise RuntimeError("the dry run joins a fake world of its own; "
                           "this process is in a real one")
    init_fake_world(world, rank)


def _mesh(plan, mesh_shape, multi_pod: bool):
    """The mesh of the joined fake world: the production mesh
    (``mesh_shape`` None), or (pod, data, model) or (data, model) as
    given; for a pipeline plan its ``STAGES`` carved out of pod x data."""
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_host_mesh,
                                         make_pipeline_mesh,
                                         make_production_mesh)
    if mesh_shape is None and not plan.pipeline:
        return make_production_mesh(multi_pod=multi_pod)
    shape = tuple(mesh_shape or PRODUCTION_SHAPES[multi_pod][0])
    axes = AXES[len(AXES) - len(shape):]
    if plan.pipeline:
        return make_pipeline_mesh(shape, axes, STAGES)
    return make_host_mesh(shape, axes)


def run_one(arch, shape_name, plan_name: Optional[str], *,
            multi_pod: bool = False, verbose: bool = True,
            grad_accum: int = 1, tcfg=None,
            mesh_shape: Optional[Sequence[int]] = None,
            ranks: Optional[Sequence[int]] = None) -> Dict:
    """The dry run's record of one combination: ``arch`` an arch id or a
    ``ModelConfig``, ``shape_name`` an ``INPUT_SHAPES`` key or a
    ``ShapeConfig``, ``plan_name`` a ``PLANS`` key or None (one device,
    no world).  The mesh is the production mesh (16 x 16, or 2 x 16 x 16
    with ``multi_pod``) unless ``mesh_shape`` gives another (pod, data,
    model) or (data, model) shape over a fake world of its size.
    ``ranks``: the ranks traced (default rank 0, or under pipeshard each
    stage's first rank; the largest peak is reported, every traced rank's
    collectives and peak in ``ranks``)."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config, get_shape
    from repro_torch.core.plans import get_plan
    from repro_torch.core.steps import plan_refusal
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import PRODUCTION_SHAPES
    from repro_torch.models import trains_through_kernels
    from repro_torch.models.registry import build_model

    cfg = arch if not isinstance(arch, str) else get_config(arch)
    shape = shape_name if not isinstance(shape_name, str) \
        else get_shape(shape_name)
    dims = mesh_shape or (PRODUCTION_SHAPES[multi_pod][0]
                          if plan_name is not None else ())
    mesh_name = "x".join(str(n) for n in dims) if dims else "one device"
    rec = {"arch": cfg.name, "shape": shape.name, "plan": plan_name,
           "mesh": mesh_name}
    reason = skip_reason(cfg, shape)
    if reason:
        return dict(rec, status="skip", reason=reason)
    reason = plan_refusal(cfg, plan_name) if plan_name is not None else ""
    if reason:
        return dict(rec, status="not_ported", reason=reason)

    tcfg = tcfg or TrainConfig(grad_accum=grad_accum)
    kernels = trains_through_kernels(cfg) if shape.kind == "train" \
        else True
    plan = get_plan(plan_name) if plan_name is not None else None
    world = 1
    for n in dims:
        world *= n
    if ranks is None:
        ranks = [0]
        if plan is not None and plan.pipeline:
            _fake_world(world, 0)
            grid = _mesh(plan, mesh_shape, multi_pod).grid
            ranks = [int(grid[s].ravel()[0]) for s in range(grid.shape[0])]
    runs = []
    try:
        for r in ranks:
            mesh = None
            if plan is not None:
                _fake_world(world, r)
                mesh = _mesh(plan, mesh_shape, multi_pod)
            model = build_model(cfg, use_kernels=kernels, device="meta")
            built = build_step(model, plan, mesh, cfg, shape, tcfg)
            if isinstance(built, str):
                return dict(rec, status="not_ported", reason=built)
            step, args, cost, state = built
            got = trace(step, args)
            del step, args
            runs.append((r, got, state))
    finally:
        if plan is not None and dist.is_initialized():
            dist.destroy_process_group()
    r, got, state = max(runs, key=lambda x: x[1]["peak"])
    n_dev = world if plan is not None else 1
    roof = rl.from_dry_run(
        got["records"], cost, got["peak"], arch=cfg.name, shape=shape.name,
        mesh_name=mesh_name, plan=plan_name or "one device",
        n_devices=n_dev, pods=dims[0] if len(dims) == 3 else 1)
    rec = dict(roof.to_dict(), plan=plan_name, status="ok",
               trace_s=round(sum(g["trace_s"] for _, g, _ in runs), 3),
               use_kernels=kernels, traced_rank=r,
               peak_split=got["split"], state_bytes=state,
               collectives=collective_counts(got["records"]),
               ranks={str(rr): {"peak": g["peak"],
                                "collectives": collective_counts(
                                    g["records"])}
                      for rr, g, _ in runs})
    if verbose:
        print(f"--- {cfg.name} x {shape.name} x {mesh_name} "
              f"({plan_name or 'one device'}) ---")
        print(f"trace {rec['trace_s']:.1f}s on rank(s) {list(ranks)}; "
              f"kernels {kernels}")
        print("peak split:", got["split"])
        print("collectives:", {k: v for k, v in rec["collectives"].items()
                               if v["calls"]})
        print(f"roofline: compute {roof.compute_s * 1e3:.3f} ms | memory "
              f"{roof.memory_s * 1e3:.3f} ms | collective "
              f"{roof.collective_s * 1e3:.3f} ms | dominant {roof.dominant} "
              f"| useful-flops {roof.useful_flops_fraction:.2f} | "
              f"mem/dev {roof.memory_per_device_bytes / 1e9:.2f} GB "
              f"(fits 80GB HBM: {roof.fits_hbm}); predicted from the H100 "
              f"data sheet's constants")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--plan", default=None,
                    help="default: shard_zero for train, shard for serve")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args()

    from repro_torch.configs import get_shape
    plan = args.plan or ("shard_zero"
                         if get_shape(args.shape).kind == "train" else "shard")
    try:
        rec = run_one(args.arch, args.shape, plan, multi_pod=args.multi_pod,
                      grad_accum=args.grad_accum)
    except Exception as e:
        traceback.print_exc()
        rec = {"arch": args.arch, "shape": args.shape, "plan": plan,
               "mesh": "multi" if args.multi_pod else "single",
               "status": "fail", "error": f"{type(e).__name__}: {e}"}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    # the reference's short JSON, and the peak and collective bytes
    print(json.dumps({k: v for k, v in rec.items()
                      if k in ("arch", "shape", "plan", "status", "dominant",
                               "reason", "error", "memory_per_device_bytes",
                               "collective_bytes_per_device",
                               "dcn_bytes_per_device")}))
    return 0 if rec["status"] in ("ok", "skip", "not_ported") else 1


if __name__ == "__main__":
    sys.exit(main())
