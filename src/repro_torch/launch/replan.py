"""Elastic re-planning launcher of the port: recover a run after sites
die (counterpart of ``repro.launch.replan``).

Two modes:

  * recovery (default): an existing checkpoint and a degraded topology.
    The job is relaunched on the surviving sites only: its world holds
    their GPUs, one rank each, dealt to the surviving sites in site
    order (``relaunch_blocks``).  It re-runs the plan search over the
    survivors, reshards the checkpoint onto the winner and resumes to
    ``--steps``:

        PYTHONPATH=src python -m torch.distributed.run --standalone \\
            --nproc_per_node 2 -m repro_torch.launch.replan \\
            --ckpt-dir /tmp/run --gpus "A30,A30;T4,T4" --dead 1 \\
            --arch gpt2m --reduced --device cpu --steps 20

  * chaos demo (``--kill-step K``): train from scratch on the full
    topology, its world one rank a GPU of every site, kill ``--dead`` at
    step K through the injection hook, replan, reshard, resume
    (``train.replan.train_elastic``); the dead sites' ranks leave the
    run and exit 0:

        PYTHONPATH=src python -m torch.distributed.run --standalone \\
            --nproc_per_node 2 -m repro_torch.launch.replan \\
            --ckpt-dir /tmp/run --gpus "A30;A30" --dead 1 --kill-step 3 \\
            --plan pipeshard --arch gpt2m --reduced --device cpu --steps 5

Under ``torch.distributed.run`` each rank uses NCCL on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``; started alone it is
a world of one.  The last stdout line, printed by the first rank of the
final mesh, is the reference's JSON summary (technique, surviving
sites, steps lost, recovery seconds, final loss); ``recovery_s`` counts
the search, the mesh and the reshard, not the resumed training (the
reference's recovery mode also counts the training in it).
"""
import argparse
import json
import time


def parse_gpus(spec: str):
    """``"A30,A30;T4,T4"`` -> per-site GPU tuples (';' between sites)."""
    sites = [tuple(g.strip() for g in s.split(",") if g.strip())
             for s in spec.split(";") if s.strip()]
    if not sites:
        raise ValueError(f"empty --gpus spec {spec!r}")
    return sites


def build_cli_topology(kind: str, gpus: str, lat_ms: float,
                       wan_gbps: float):
    """An N-site topology from CLI args (full / ring / line / hub)."""
    from repro_torch.core.topology import (Link, Site, fully_connected,
                                           hub, line, ring)
    site_gpus = parse_gpus(gpus)
    sites = [Site(g, name=f"V{i + 1}") for i, g in enumerate(site_gpus)]
    edge = Link(lat_ms * 1e-3, wan_gbps)
    name = f"{kind}{len(sites)}"
    if kind == "full":
        return fully_connected(name, sites, edge)
    if kind == "ring":
        return ring(name, sites, [edge] * len(sites))
    if kind == "line":
        return line(name, sites, [edge] * (len(sites) - 1))
    if kind == "hub":
        return hub(name, sites[0], sites[1:], edge)
    raise ValueError(f"unknown --kind {kind!r}")


def relaunch_blocks(topo, dead, ranks=None):
    """Per-site rank blocks of a job relaunched on the survivors: the
    world's ranks (or ``ranks``) dealt to the surviving sites in site
    order, one a GPU; a dead site gets none."""
    from repro_torch.train.replan import site_device_blocks
    survivor, kept = topo.without_sites(dead)
    blocks = [()] * topo.n_sites
    for j, block in enumerate(site_device_blocks(survivor, ranks)):
        blocks[kept[j]] = block
    return blocks


def recover(model, topo, dead, wl, tcfg, loader, *, ckpt_dir: str,
            steps: int, ckpt_every: int = 2, save: bool = True,
            model_axis: int = 1, log_every: int = 0, log_fn=print):
    """The recovery mode on this rank of a world of the survivors' ranks:
    replan over the survivors of ``topo`` minus ``dead`` for ``wl``,
    reshard the newest checkpoint of ``ckpt_dir`` onto the winner and
    train to ``steps`` from its step (saving into ``ckpt_dir`` unless
    ``save`` is False).  A rank of a surviving site the winner leaves
    out takes no step.

    Returns:
        This rank's ``train.replan.ElasticRun``.

    Raises:
        RuntimeError: no complete checkpoint in ``ckpt_dir``.
    """
    import torch.distributed as dist

    from repro_torch.core.plans import get_plan
    from repro_torch.launch.mesh import placement_mesh
    from repro_torch.train import (latest_checkpoint, replan,
                                   reshard_checkpoint, train)
    from repro_torch.train.loop import TrainResult
    from repro_torch.train.replan import ElasticRun, placement_devices

    ckpt = latest_checkpoint(ckpt_dir)
    if ckpt is None:
        raise RuntimeError(f"no complete checkpoint in {ckpt_dir}")
    t0 = time.perf_counter()
    rp = replan(topo, dead, wl)
    plan = get_plan(rp.technique)
    mesh = placement_mesh(rp.topology, plan, rp.placement,
                          model=model_axis,
                          ranks=placement_devices(relaunch_blocks(topo, dead),
                                                  rp.sites_old))
    if not mesh.holds_me:
        return ElasticRun(result=TrainResult(), replan=rp,
                          search_s=rp.search_s, mesh=mesh, left=True)
    t1 = time.perf_counter()
    params, opt, step0 = reshard_checkpoint(ckpt, model, plan, mesh,
                                            placement=rp.placement)
    t2 = time.perf_counter()
    if dist.get_rank() == mesh.first_rank:
        log_fn(f"replanned: {rp.technique} on original sites "
               f"{rp.sites_old} ({rp.tflops:.2f} model-TFLOP/s); "
               f"resuming at step {step0}")
    res = train(model, tcfg, loader, steps=steps, start_step=step0,
                params=params, opt_state=opt, sharded=True,
                ckpt_dir=ckpt_dir if save else None,
                ckpt_every=ckpt_every if save else 0,
                stage_layers=rp.placement.stage_layers,
                schedule=rp.placement.schedule, log_every=log_every,
                log_fn=log_fn, plan=plan, mesh=mesh)
    return ElasticRun(result=res, replan=rp, resumed_from=step0,
                      search_s=rp.search_s, reshard_s=t2 - t1,
                      recovery_s=t2 - t0, mesh=mesh)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--gpus", default="A30,A30;T4,T4",
                    help="per-site GPUs: ';' between sites, ',' within")
    ap.add_argument("--kind", default="full",
                    choices=("full", "ring", "line", "hub"))
    ap.add_argument("--latency-ms", type=float, default=20.2)
    ap.add_argument("--wan-gbps", type=float, default=3.0)
    ap.add_argument("--dead", default="1",
                    help="comma-separated dead site indices (0-based)")
    ap.add_argument("--kill-step", type=int, default=-1,
                    help=">= 0: chaos-demo mode — train from scratch and "
                         "inject the failure at this step")
    ap.add_argument("--plan", default="auto",
                    help="initial plan for the chaos demo ('auto' = "
                         "search the full topology)")
    ap.add_argument("--arch", default="gpt2m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (NCCL, kernels) or cpu (gloo, the plain "
                         "PyTorch versions)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--docs", type=int, default=200)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core.costmodel import Workload
    from repro_torch.core.plans import Placement
    from repro_torch.core.search import PlanSearch
    from repro_torch.data import (Loader, Tokenizer, build_dataset,
                                  synthetic_wikipedia)
    from repro_torch.launch.mesh import init_world
    from repro_torch.models import Model, trains_through_kernels
    from repro_torch.train import kill_site_at, train_elastic

    topo = build_cli_topology(args.kind, args.gpus, args.latency_ms,
                              args.wan_gbps)
    dead = tuple(int(x) for x in args.dead.split(",") if x.strip())
    dev = init_world(args.device)
    try:
        texts = list(synthetic_wikipedia(args.docs, seed=args.seed))
        tok = Tokenizer.train(texts, args.vocab)
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size,
                                  max_seq_len=max(cfg.max_seq_len, args.seq))
        ds = build_dataset(texts, tok, seq_len=args.seq)
        loader = Loader(ds, global_batch=args.batch, seed=args.seed)
        tcfg = TrainConfig(warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps, seed=args.seed,
                           microbatches=args.microbatches)
        model = Model(cfg, device=dev,
                      use_kernels=trains_through_kernels(cfg))
        wl = Workload(cfg, args.seq, args.batch, steps_per_epoch=args.steps,
                      microbatches=args.microbatches)
        if dist.get_rank() == 0:
            print(f"{cfg.name} {cfg.param_count() / 1e6:.1f}M params on "
                  f"{topo.name} ({dist.get_world_size()} ranks): "
                  f"{topo.describe()}", flush=True)

        if args.kill_step >= 0:
            # chaos-demo mode: full run with an injected failure
            if args.plan == "auto":
                search = PlanSearch(wl, topo, stage_balance="tflops")
                top = search.best()
                if top is None:
                    raise SystemExit("no feasible plan on the full topology")
                technique = top.candidate.technique
                placement = search.placement(top.candidate)
            else:
                technique = args.plan
                placement = Placement(tuple(range(topo.n_sites)))
            if dist.get_rank() == 0:
                print(f"initial plan: {technique}@{placement.sites}",
                      flush=True)
            run = train_elastic(
                model, topo, technique, placement, tcfg, loader,
                steps=args.steps, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                on_step_failure=kill_site_at(args.kill_step, dead))
            summary = {
                "mode": "chaos", "failed": run.failed,
                "technique": run.replan.technique if run.replan
                else technique,
                "sites_old": list(run.replan.sites_old) if run.replan
                else list(placement.sites),
                "resumed_from": run.resumed_from,
                "steps_lost": run.steps_lost,
                "search_s": run.search_s, "reshard_s": run.reshard_s,
                "recovery_s": run.recovery_s,
                "final_loss": run.result.losses[-1] if run.result.losses
                else None,
            }
        else:
            run = recover(model, topo, dead, wl, tcfg, loader,
                          ckpt_dir=args.ckpt_dir, steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          log_every=max(args.steps // 10, 1))
            summary = {
                "mode": "recovery", "technique": run.replan.technique,
                "sites_old": list(run.replan.sites_old),
                "resumed_from": run.resumed_from,
                "search_s": run.search_s, "reshard_s": run.reshard_s,
                "recovery_s": run.recovery_s,
                "final_loss": run.result.losses[-1] if run.result.losses
                else None,
            }
        if run.main:
            summary["step_s"] = run.result.step_times
            summary["save_s"] = run.result.save_times
            if run.pre is not None:
                summary["step_s_pre"] = run.pre.step_times
            summary["peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
                if dev.type == "cuda" else None
            print(json.dumps(summary), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
