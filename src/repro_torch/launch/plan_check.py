"""Numerical plan-equivalence check of the port (counterpart of
``repro.launch.plan_check``).

Spawns ``--world`` ranks on ``torch.distributed`` (NCCL, one card a
rank, or gloo with ``--device cpu``), lays them out as ``--mesh`` over
``("pod", "data", "model")`` and trains a small model of ``--arch`` (any
ported family) a few steps under each plan, by default every plan of
``PLANS``, as the reference's check does; every plan computes the same
update as one device, so the losses and the norm of the params after
the updates must agree with the one-device run's, which rank 0 also
makes.  The MoE family routes each batch rank's tokens on their own
(each pipeline microbatch as one), as the reference does: a plan's
yardstick is then the one-device run with ``grad_accum`` equal to the
groups it routes apart (``routed_groups``), keyed ``one_device@<n>``
for n above one.  pipeshard reshapes the mesh
into ``--stages`` stages (``launch.mesh.make_pipeline_mesh``) and runs
once for each of ``--schedules`` with ``--microbatches`` and
``--stage-layers``; a schedule other than GPipe keys its record
``pipeshard@<schedule>``.  Prints one JSON line: ``{plan: {"losses":
[...], "param_norm": x, "step_ms": t, "sends_a_step": n,
"send_bytes_a_step": b, "routed_groups": n, "collectives_a_step":
{kind: {"calls": n, "bytes": b}}, "peak_bytes": [...]}, ...,
"one_device": {...}}``, ``step_ms`` the mean host time of the steps
after the first (each ends when its loss reaches the host), the sends
summed over the world's ranks, the collectives rank 0's, ``peak_bytes``
each rank's peak device memory over the plan's steps (None on the
CPU).  ``--full`` runs the architecture at its full width and depth in
place of the reduced one (``--layers`` cuts its depth).  On the card the
families whose kernels have no backward train through the plain
versions (``models.trains_through_kernels``), and every step updates
its params and optimizer state in place (``donate``).

    PYTHONPATH=src python -m repro_torch.launch.plan_check --device cpu \\
        --world 4 --mesh 1,2,2
    PYTHONPATH=src python -m repro_torch.launch.plan_check --world 4 \\
        --arch gpt2L --full --seq 1024 --steps 3     # four cards
    PYTHONPATH=src python -m repro_torch.launch.plan_check --device cpu \\
        --world 4 --arch zamba2-2.7b --layers 4 --plans shard,fsdp
"""
import argparse
import dataclasses
import json
import os
import tempfile
import time

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.core.plans import PLANS



def _param_norm(tree) -> float:
    import torch

    from repro_torch.optim.adamw import tree_leaves
    return float(torch.sqrt(sum(t.double().square().sum()
                                for t in tree_leaves(tree))))


def _rank(rank: int, args, store: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import sharding
    from repro_torch.core.plans import get_plan
    from repro_torch.core.steps import build_train_step
    from repro_torch.launch.mesh import make_host_mesh, make_pipeline_mesh
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.optim import init_adamw

    if args.device == "cuda":
        torch.cuda.set_device(rank)
        device, backend = f"cuda:{rank}", "nccl"
    else:
        torch.set_num_threads(1)
        device, backend = "cpu", "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=args.world)
    try:
        shape = [int(x) for x in args.mesh.split(",")]
        axes = ("pod", "data", "model")
        mesh = make_host_mesh(shape, axes)
        split = None if args.stage_layers is None else \
            tuple(int(x) for x in args.stage_layers.split(","))
        # fp32 on the CPU, where the plans agree to fp32 rounding; bf16 on
        # the card, which kernel A takes
        cfg = get_config(args.arch)
        if not args.full:
            cfg = cfg.reduced()
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        elif not args.full:
            cfg = dataclasses.replace(cfg, n_layers=2)
        cfg = dataclasses.replace(
            cfg, dtype="bfloat16" if args.device == "cuda" else "float32")
        use_kernels = trains_through_kernels(cfg)
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10, microbatches=args.microbatches)
        rng = np.random.default_rng(0)
        batch = {k: rng.integers(0, cfg.vocab_size, (args.batch, args.seq))
                 for k in ("tokens", "labels")}

        def fresh(model):
            gen = torch.Generator(device=model.device).manual_seed(0)
            return model.init(gen)

        def steps(step, params, opt, batch):
            if args.device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            losses, times = [], []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                losses.append(float(metrics["loss"]))
                times.append(time.perf_counter() - t0)
            later = times[1:] or times
            return params, {"losses": losses,
                            "step_ms": 1e3 * sum(later) / len(later)}

        def peaks():
            """Every rank's peak device memory since the last reset."""
            if args.device != "cuda":
                return None
            t = torch.zeros(args.world, dtype=torch.float64, device=device)
            t[rank] = torch.cuda.max_memory_allocated()
            dist.all_reduce(t)
            return [int(x) for x in t.tolist()]

        runs = []
        for name in args.plans.split(","):
            if name != "pipeshard":
                runs.append((name, name, mesh, {}))
                continue
            for sched in args.schedules.split(","):
                runs.append((name if sched == "gpipe" else
                             f"{name}@{sched}", name, make_pipeline_mesh(
                                 shape, axes, args.stages,
                                 stage_layers=split, schedule=sched),
                             dict(stage_layers=split, schedule=sched)))
        results = {}
        for key, name, on, kw in runs:
            model = Model(cfg, device=device, use_kernels=use_kernels)
            step = build_train_step(model, tcfg, plan=name, mesh=on,
                                    donate=True, **kw)
            params = step.shard_params(fresh(model))
            sharding.reset_collective_counts()
            params, rec = steps(step, params, step.init_opt_state(), batch)
            counts = sharding.collective_counts()
            sent = torch.tensor([counts["send"]["calls"],
                                 counts["send"]["bytes"]],
                                dtype=torch.float64, device=device)
            dist.all_reduce(sent)
            rec["sends_a_step"] = float(sent[0]) / args.steps
            rec["send_bytes_a_step"] = float(sent[1]) / args.steps
            rec["collectives_a_step"] = {
                k: {"calls": v["calls"] / args.steps,
                    "bytes": v["bytes"] / args.steps}
                for k, v in counts.items()}
            rec["peak_bytes"] = peaks()
            axes_b = step.batch_axes(args.batch)
            # the groups the MoE family routes apart: the batch ranks, or
            # a pipeline's microbatches (each routed as one)
            rec["routed_groups"] = 1 if cfg.family != "moe" else \
                args.microbatches if get_plan(name).pipeline else \
                (on.count(axes_b) if axes_b else 1)
            rec["param_norm"] = _param_norm(step.gather_params(params))
            results[key] = rec
            del params, step
            if args.device == "cuda":
                torch.cuda.empty_cache()
        if rank == 0:
            tb = {k: torch.as_tensor(v, device=device)
                  for k, v in batch.items()}
            for n in sorted({r["routed_groups"] for r in results.values()}
                            | {1}):
                model = Model(cfg, device=device, use_kernels=use_kernels)
                step = build_train_step(
                    model, dataclasses.replace(tcfg, grad_accum=n),
                    donate=True)
                params = fresh(model)
                params, rec = steps(step, params, init_adamw(params), tb)
                rec["param_norm"] = _param_norm(params)
                results["one_device" if n == 1 else f"one_device@{n}"] = rec
                del params
            print(json.dumps(results), flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--mesh", default=None,
                    help="(pod, data, model) shape; default 1,2,2 for a "
                         "world of 4, else 1,world,1")
    ap.add_argument("--arch", default="gpt2m", choices=sorted(ARCH_CONFIGS),
                    help="any ported architecture: dense, MoE, SSM, hybrid")
    ap.add_argument("--plans", default=",".join(PLANS),
                    help="comma-separated repro_torch.core.plans.PLANS keys "
                         "(default all)")
    ap.add_argument("--stages", type=int, default=None,
                    help="pipeline stages of pipeshard; default 2 where "
                         "pod x data splits in two, else 1")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--schedules", default="gpipe",
                    help="comma-separated pipeline schedules of pipeshard")
    ap.add_argument("--stage-layers", default=None,
                    help="layers of each chunk (pipeshard; default even)")
    ap.add_argument("--full", action="store_true",
                    help="the architecture at full width and depth")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default 2 for the reduced architecture, "
                         "the full depth with --full)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, one card a rank) or cpu (gloo)")
    args = ap.parse_args(argv)
    if args.mesh is None:
        args.mesh = "1,2,2" if args.world == 4 else f"1,{args.world},1"
    if args.stages is None:
        pod, data, _ = (int(x) for x in args.mesh.split(","))
        args.stages = 2 if (pod * data) % 2 == 0 else 1

    import torch
    import torch.multiprocessing as mp

    from repro_torch import resolve_device
    if args.device == "cuda":
        resolve_device("cuda")                    # raises without a card
        if torch.cuda.device_count() < args.world:
            raise RuntimeError(f"--world {args.world} needs as many cards, "
                               f"{torch.cuda.device_count()} present")
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(args, os.path.join(d, "store")),
                           nprocs=args.world, start_method="spawn")


if __name__ == "__main__":
    main()
